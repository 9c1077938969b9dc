"""The port stands alone: no JAX, no ``repro``, no silent host fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 30  # every module of the slice imported


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_reference(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_cuda_device_without_card_raises(monkeypatch):
    from repro_torch.core import JasdaScheduler, SliceSpec
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels.common import resolve_device
    from repro_torch.kernels.jasda_score.ops import score_variants

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JasdaScheduler([SliceSpec("s0", 1 << 30)], SchedulerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        score_variants([[0.5]], [[0.5]], [1.0], [1.0], [[0.0]], [[0.0]],
                       lam=0.5, capacity=1.0, theta=1.0)
    assert resolve_device("cpu").type == "cpu"


def test_missing_toolkit_is_a_plain_error(monkeypatch, tmp_path):
    """A kernel that cannot build raises RuntimeError, never the ladder's
    KernelDispatchError, so no backend is stepped over silently."""
    from repro_torch.kernels import common

    monkeypatch.setattr(common, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(common.shutil, "which", lambda _name: None)
    monkeypatch.setattr(common, "NVCC_FALLBACK", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError) as info:
        common.build_all(["jasda_score"])
    assert not isinstance(info.value, common.KernelDispatchError)
