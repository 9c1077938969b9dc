"""Shared kernel utilities: device choice, fault surface, build + numerics.

The port's counterpart of ``repro/kernels/common.py``.  It owns:

* the device choice: entry points run on the CUDA card unless the caller
  asks for the CPU (:func:`resolve_device`); asking for ``"cuda"`` on a
  machine without a card raises instead of running on the host;
* the fault surface shared by ``jasda_score`` and ``wis_dp``: a typed
  :class:`KernelDispatchError` and the sticky :class:`BackendHealth`
  ladder ``("cuda", "torch", "numpy")``.  The ladder serves INJECTED
  dispatch faults only (``inject_dispatch_fault``, the simulator's
  ``device_dispatch_fail`` event).  A kernel that fails to build or whose
  launch is refused raises a plain ``RuntimeError``, so a broken kernel
  never steps down the ladder silently;
* the hand-written CUDA build: every ``csrc/*.cu`` is compiled by ``nvcc``
  on first use into a shared library with a plain C interface, loaded with
  ``ctypes`` (:func:`load_kernel_library`, :func:`build_all`);
* ``log_ndtr`` in torch with the reference's three branches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = [
    "cuda_available",
    "resolve_device",
    "log_ndtr",
    "KernelDispatchError",
    "BackendHealth",
    "DEGRADATION_LADDER",
    "inject_dispatch_fault",
    "clear_dispatch_faults",
    "check_dispatch_fault",
    "dispatch_faults_snapshot",
    "restore_dispatch_faults",
    "load_kernel_library",
    "build_all",
    "build_counts",
    "check_launch",
    "check_tensor",
    "CSRC_DIR",
    "BUILD_DIR",
]

#: backend order the scheduler walks when a dispatch fault is injected;
#: "numpy" is the host float64 reference and never raises KernelDispatchError.
DEGRADATION_LADDER = ("cuda", "torch", "numpy")


class KernelDispatchError(RuntimeError):
    """An injected dispatch fault; carries backend + bucketed operand shape.

    Only :func:`check_dispatch_fault` raises it.  Real build or launch
    failures of a CUDA kernel are plain ``RuntimeError``s and propagate.
    """

    def __init__(self, backend: str, op: str,
                 shape: Tuple[int, ...] = (),
                 cause: Optional[BaseException] = None):
        self.backend = backend
        self.op = op
        self.shape = tuple(int(s) for s in shape)
        self.cause = cause
        detail = f" <- {type(cause).__name__}: {cause}" if cause else ""
        super().__init__(
            f"{op}[{backend}] dispatch failed at bucket shape "
            f"{self.shape}{detail}")


class BackendHealth:
    """Sticky per-backend health: once a backend fails it stays failed.

    One instance is shared by a scheduler's scoring AND settle dispatches,
    so a cuda fault seen while scoring also steers the round's WIS settle
    away from cuda.  ``resolve(preferred)`` walks the degradation ladder
    from the preferred backend to the first healthy one ("numpy" is always
    healthy).  Stickiness makes fault landing deterministic across serial
    and pipelined runs.
    """

    def __init__(self) -> None:
        self._failed: Dict[str, str] = {}

    def mark_failed(self, backend: str, reason: str = "") -> None:
        self._failed.setdefault(backend, reason)

    def healthy(self, backend: str) -> bool:
        return backend not in self._failed

    def resolve(self, preferred: str) -> str:
        """First healthy backend at or below ``preferred`` on the ladder."""
        if preferred not in DEGRADATION_LADDER:
            return preferred if self.healthy(preferred) else "numpy"
        start = DEGRADATION_LADDER.index(preferred)
        for backend in DEGRADATION_LADDER[start:]:
            if self.healthy(backend):
                return backend
        return "numpy"

    def failed_backends(self) -> Dict[str, str]:
        return dict(self._failed)

    # snapshot/restore hooks used by checkpointed crash recovery ---------
    def snapshot(self) -> Dict[str, str]:
        return dict(self._failed)

    def restore(self, snap: Dict[str, str]) -> None:
        self._failed = dict(snap)


# Armed one-shot dispatch faults: backend -> remaining failure count.
# Module-level because the dispatch functions are free functions;
# determinism comes from the FAULT PLAN arming them at seeded times.
_ARMED_FAULTS: Dict[str, int] = {}


def inject_dispatch_fault(backend: str, count: int = 1) -> None:
    """Arm ``count`` dispatch failures for ``backend`` (test/sim hook)."""
    _ARMED_FAULTS[backend] = _ARMED_FAULTS.get(backend, 0) + int(count)


def clear_dispatch_faults() -> None:
    _ARMED_FAULTS.clear()


def dispatch_faults_snapshot() -> Dict[str, int]:
    """Armed-but-unfired faults (checkpointed so crash restore replays a
    fault armed between the checkpoint and the crash exactly once)."""
    return dict(_ARMED_FAULTS)


def restore_dispatch_faults(snap: Dict[str, int]) -> None:
    _ARMED_FAULTS.clear()
    _ARMED_FAULTS.update({k: int(v) for k, v in snap.items()})


def check_dispatch_fault(backend: str, op: str,
                         shape: Tuple[int, ...] = ()) -> None:
    """Raise KernelDispatchError if a fault is armed for ``backend``."""
    n = _ARMED_FAULTS.get(backend, 0)
    if n > 0:
        if n == 1:
            _ARMED_FAULTS.pop(backend, None)
        else:
            _ARMED_FAULTS[backend] = n - 1
        raise KernelDispatchError(
            backend, op, shape,
            cause=RuntimeError("injected dispatch fault"))


# ---------------------------------------------------------------------------
# Device choice
# ---------------------------------------------------------------------------


def cuda_available() -> bool:
    """True when torch sees a CUDA card (the port's ``use_interpret`` twin)."""
    return torch.cuda.is_available()


def resolve_device(device=None, mesh=None) -> torch.device:
    """The torch device an entry point runs on: the card unless asked.

    ``None`` means ``"cuda"``.  A CUDA device on a machine without a card
    raises: the port never moves a device run to the host behind the
    caller's back.  ``"meta"`` is admitted when the caller names it (the
    dry run's shape-only tensors, ``launch/dryrun.py``); no kernel
    launches on it.  With an auction ``mesh`` (``launch/mesh.py``) the
    device backends run on the mesh's devices and gather their results on
    ``mesh.devices[0]``, which is returned; a ``device`` of another type
    than that one raises ``ValueError``.
    """
    if mesh is not None:
        first = mesh.devices[0]
        if device is not None and torch.device(device).type != first.type:
            raise ValueError(
                f"device {str(device)!r} does not match the mesh's devices "
                f"({str(first)!r})")
        device = first
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not cuda_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain torch versions on the host")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


# ---------------------------------------------------------------------------
# Hand-written CUDA kernels: build with nvcc on first use, bind with ctypes
# ---------------------------------------------------------------------------

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
#: build outputs live beside the sources, inside the checkout (gitignored)
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: the kernels must round like their plain torch
    # versions, which run every multiply and add as its own rounded op
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: nvcc invocations per kernel source in this process (the port's
#: counterpart of the JAX package's retrace counters: kernels are not
#: specialised per shape, so each source builds at most once)
_BUILDS: Dict[str, int] = {}
#: ptxas register / shared-memory report of each build (``-Xptxas -v``)
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_counts() -> Dict[str, int]:
    """nvcc builds per kernel source so far in this process."""
    return dict(_BUILDS)


#: where the CUDA toolkit's compiler lives when it is not on PATH
NVCC_FALLBACK = Path("/usr/local/cuda/bin/nvcc")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_FALLBACK.exists():
        return str(NVCC_FALLBACK)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from "
        f"{CSRC_DIR} on first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (Popen, tmp, out) or None if built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    _BUILDS[name] = _BUILDS.get(name, 0) + 1


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Build every kernel source at once (one nvcc per source, in parallel).

    Returns the ptxas report of each source built by this call.
    """
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with _LOCK:
        jobs = {n: _start_build(n) for n in names}
        errors = []
        for n, job in jobs.items():  # wait for every nvcc, even after a failure
            if job is not None:
                try:
                    _finish_build(n, job)
                except RuntimeError as exc:
                    errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: BUILD_LOGS.get(n, "") for n in names if jobs[n] is not None}


def load_kernel_library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each exported C function to its ``argtypes``; every
    function returns an ``int`` (a ``cudaError_t`` for the launchers).
    """
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check_launch(err: int, kernel: str) -> None:
    """Raise if the C launcher reported a non-zero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {kernel} was not launched: cudaError_t {err}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: Tuple[int, ...], device: torch.device) -> None:
    """Validate what a kernel wrapper hands to native code as a pointer."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

_SQRT_HALF = 0.7071067811865476
_SQRT_2PI = 2.5066282746310002


def log_ndtr(z: torch.Tensor) -> torch.Tensor:
    """log Φ(z) with the reference's three branches and branch points.

    z ≥ −1 → log1p(−erfc(z/√2)/2); −10 ≤ z < −1 → log(erfc(−z/√2)/2);
    z < −10 → the asymptote −z²/2 − log(−z·√(2π)).  Not
    ``torch.special.log_ndtr``: a different tail can flip eligibility
    where p_exceed ≈ θ.  Each op rounds on its own, in the order the CUDA
    kernel (csrc/jasda_score.cu) evaluates it.  The reference clips the
    left branch at 1e-300, which is 0 in float32.
    """
    x = z * _SQRT_HALF
    right = torch.log1p(-0.5 * torch.erfc(x))
    left = torch.log(torch.clamp(0.5 * torch.erfc(-x), min=0.0))
    asym = -0.5 * z * z - torch.log(-z * _SQRT_2PI + 1e-30)
    return torch.where(z >= -1.0, right, torch.where(z >= -10.0, left, asym))
