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
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "examples" / f"{name}_torch.py"
    for name in ("quickstart", "cluster_study", "serve_batch", "train_100m")] + [
    ROOT / "tests" / f"test_torch_card_{name}.py"
    for name in ("kernels", "auction", "models", "adamw")]


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
        "bad = [m for m in sys.modules if m.split('.')[0]\n"
        "       in ('jax', 'ml_dtypes', 'repro')]\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # every module of the three slices imported: the auction round; the
    # linear scan, models, configs, serving engine and launcher; flash
    # attention and the single-window WIS
    assert int(out.stdout.strip()) > 50
    for name in ("kernels.flash_attention.kernel", "kernels.flash_attention.ops",
                 "kernels.flash_attention.ref", "kernels.wis_dp.ops",
                 "checkpoint.store", "core.repartition", "service.engine",
                 "serving.adapter", "launch.serve_auction",
                 "training.optimizer", "training.schedule", "training.trainer",
                 "data.pipeline", "distributed.compression", "core.executor",
                 "core.baselines", "launch.train", "models.moe",
                 "configs.olmoe_1b_7b", "configs.granite_moe_3b_a800m",
                 "configs.qwen3_14b", "configs.qwen1_5_4b",
                 "configs.starcoder2_15b", "configs.llama3_405b",
                 "configs.whisper_small", "configs.llama3_2_vision_90b",
                 "launch.mesh", "distributed.sharding", "configs.shapes",
                 "launch.costmodel", "launch.roofline", "launch.dryrun",
                 "launch.report"):
        assert (PORT / (name.replace(".", "/") + ".py")) in PORT_FILES


def test_every_reference_module_has_a_twin():
    ref = ROOT / "src" / "repro"
    missing = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py")
                     if not (PORT / p.relative_to(ref)).exists())
    assert missing == []


def test_dry_run_imports_no_jax():
    """The dry run and the report, the tools a user runs on a host without
    the card, load neither JAX nor the reference."""
    code = (
        "import sys\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.report\n"
        "bad = [m for m in sys.modules if m.split('.')[0]\n"
        "       in ('jax', 'ml_dtypes', 'repro')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_meta_is_asked_for_and_never_launches(monkeypatch):
    """``"meta"`` is a device only when named: None still means the card.
    K4's wrapper refuses meta tensors rather than launch on them."""
    from repro_torch.kernels.common import resolve_device
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import kernel as k4

    assert resolve_device("meta").type == "meta"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    q = torch.empty(1, 2, 64, 64, device="meta", dtype=torch.bfloat16)
    before = dict(k4.LAUNCHES)
    for impl in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="meta"):
            flash_attention(q, q, q, causal=True, impl=impl)
    assert k4.LAUNCHES == before


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_reference(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "ml_dtypes", "repro"), (path, name)


def test_cuda_device_without_card_raises(monkeypatch):
    from repro_torch.core import JasdaScheduler, SliceSpec
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels.common import resolve_device
    from repro_torch.kernels.jasda_score.ops import score_variants
    from repro_torch.configs import reduced
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving import ServeConfig, ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JasdaScheduler([SliceSpec("s0", 1 << 30)], SchedulerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        score_variants([[0.5]], [[0.5]], [1.0], [1.0], [[0.0]], [[0.0]],
                       lam=0.5, capacity=1.0, theta=1.0)
    from repro_torch.kernels import wis_clear
    from repro_torch.kernels.wis_dp.ops import wis_dp

    with pytest.raises(RuntimeError, match="no CUDA device"):
        wis_clear([0.0], [1.0], [1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wis_dp([1.0], [0])
    model = Model(reduced("falcon_mamba_7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, model.init(0, device="cpu"), ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "falcon_mamba_7b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "recurrentgemma_9b", "--reduced",
                    "--attn-impl", "pallas"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "olmoe_1b_7b", "--reduced", "--attn-impl",
                    "pallas"])
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "falcon_mamba_7b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(reduced("falcon_mamba_7b"), steps=1)
    for arch in ("whisper_small", "llama3_2_vision_90b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(reduced(arch)).init(0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", arch, "--reduced", "--steps", "1"])
    from repro_torch.launch.mesh import make_auction_mesh, make_production_mesh

    # the auction mesh takes the visible cards, never the host
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_auction_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_auction_mesh(4, devices=["cuda"] * 4)
    # so does the production mesh: a host mesh only when "cpu" is named
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()
    assert make_production_mesh(devices=["cpu"]).devices == (torch.device("cpu"),)
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


def test_every_kernel_source_has_a_wrapper():
    """Each csrc/*.cu is loaded by a kernel.py, and every C function the
    wrapper binds is defined in that source."""
    from repro_torch.kernels.adamw import kernel as kadamw
    from repro_torch.kernels.flash_attention import kernel as k4
    from repro_torch.kernels.jasda_score import kernel as k1
    from repro_torch.kernels.linear_scan import kernel as k5
    from repro_torch.kernels.wis_dp import kernel as k2

    wrappers = {"adamw": kadamw, "flash_attention": k4, "jasda_score": k1,
                "linear_scan": k5, "wis_batch": k2}
    sources = sorted(p.stem for p in (PORT / "kernels" / "csrc").glob("*.cu"))
    assert sources == sorted(wrappers)
    for name, mod in wrappers.items():
        text = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
        for fn in mod._SIGNATURES:
            assert f"int {fn}(" in text, (name, fn)
