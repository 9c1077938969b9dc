"""What every cell shares: finding its files, spans, the profiler, the
result line.

A driver (``drivers/<name>.py``) gets a :class:`Harness`.  It builds the
program's objects, wraps their bound methods with :meth:`Harness.wrap` to
time the calls into each layer, opens and closes the measured window, and
returns what it measured and the numbers it compared.  ``run.py`` turns
that into the contract's last line.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
#: top-level module names the process that prints a result must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: prefix of the profiler ranges the harness records around its spans
RANGE = "bench:"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def driver(name: str):
    return importlib.import_module(f"bench.drivers.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py`` (names may hold dots, so load it by path)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def kernel_label(name: str) -> str:
    """A short name for a device activity: its kernel function or functor."""
    import re

    generic = {"vectorized_elementwise_kernel", "unrolled_elementwise_kernel",
               "elementwise_kernel", "BinaryFunctor", "AUnaryFunctor",
               "BUnaryFunctor", "void", "at", "native", "detail"}
    for word in re.findall(r"[A-Za-z_]\w*", name):
        if word not in generic and (word.endswith(("Functor", "_kernel",
                                                   "Kernel", "Copy"))
                                    or word.startswith(("nvjet", "sm90",
                                                        "CUDAFunctor"))):
            return word
    return name[:60]


#: the program's kernel modules whose launch and shape counters are read
KERNEL_MODULES = ("jasda_score", "wis_dp", "linear_scan", "flash_attention")


def kernel_counts() -> dict:
    """Snapshot of the kernels' ``LAUNCHES`` and ``SHAPES`` counters."""
    out = {}
    for name in KERNEL_MODULES:
        mod = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
        out.update({k: v for k, v in mod.LAUNCHES.items()})
        out[f"{name}.shapes"] = dict(mod.SHAPES)
    return out


def counts_since(before: dict, after: dict) -> dict:
    """Launches, and launches by shape, between two snapshots."""
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            old = before.get(k, {})
            out[k] = {s: n - old.get(s, 0) for s, n in v.items()
                      if n - old.get(s, 0)}
        else:
            out[k] = v - before.get(k, 0)
    return out


class Trace:
    """One profiled stretch: the device's activities and the harness's
    host ranges, on the profiler's clock (nanoseconds)."""

    def __init__(self, kernels, ranges, t0: int, t1: int):
        self.kernels = kernels  # [(name, start, end)]
        self.ranges = ranges  # [(span name, start, end)]
        self.t0, self.t1 = t0, t1
        self._busy = self._merge([(a, b) for _, a, b in kernels])

    @staticmethod
    def _merge(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_between(self.t0, self.t1)

    def busy_between(self, a: int, b: int) -> float:
        """Seconds in [a, b] in which some device activity ran."""
        s = 0
        for x, y in self._busy:
            lo, hi = max(x, a), min(y, b)
            if hi > lo:
                s += hi - lo
        return s / 1e9

    def kernel_seconds(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Summed seconds and count of the activities whose name matches."""
        ks = [(b - a) for n, a, b in self.kernels if match(n)]
        return sum(ks) / 1e9, len(ks)

    def spans(self, name: str):
        return [(a, b) for n, a, b in self.ranges if n == name]

    def breakdown(self, top: int = 10) -> dict:
        by = {}
        for n, a, b in self.kernels:
            if b > self.t0 and a < self.t1:
                k = kernel_label(n)
                by[k] = by.get(k, 0.0) + (min(b, self.t1) - max(a, self.t0)) / 1e9
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        edge = self.t0
        inside = [(max(a, self.t0), min(b, self.t1)) for a, b in self._busy
                  if b > self.t0 and a < self.t1]
        for a, b in inside + [(self.t1, self.t1)]:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        named = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (a + b) / 2
            inner = [(y - x, n) for n, x, y in self.ranges if x <= mid <= y]
            named.append([min(inner)[1] if inner else "outside every span",
                          (b - a) / 1e9])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


class Harness:
    """One run of one cell: its parameters, clock, spans and trace."""

    def __init__(self, *, cell: str, seed: int, seconds: float, trace: bool,
                 device: str, t_process: float, overrides: Optional[dict] = None):
        self.cell_name = cell
        self.cell = workload(cell)
        self.config = config(self.cell["config"])
        self.params = dict(self.cell["params"])
        self.params.update(overrides or {})
        self.limits = dict(self.cell["limits"])
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_process = t_process
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.counters: Dict[str, object] = {}
        self.trace_data: Optional[Trace] = None
        self.memory_peak_bytes = 0
        self._prof = None
        self._profiling = False

    # -- the window ------------------------------------------------------
    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def open_window(self) -> None:
        """Set-up ends here: the cyclic collector is collected once and
        left on, the device is idle, the peak counter starts."""
        gc.collect()
        self.sync()
        if self.device == "cuda":
            import torch

            torch.cuda.reset_peak_memory_stats()
        self.t_open = time.perf_counter()

    def close_window(self) -> None:
        """The window ends here; a stretch still being traced ends with it."""
        self.sync()
        self.t_close = time.perf_counter()
        self.stop_trace()

    @property
    def window_open(self) -> bool:
        return self.t_open is not None and self.t_close is None

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_open

    @property
    def setup_s(self) -> float:
        return self.t_open - self.t_process

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def read_peak(self) -> None:
        """The device's peak allocation, set-up and window included (call
        once the window has closed, before the reference runs)."""
        if self.device == "cuda":
            import torch

            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    # -- spans -----------------------------------------------------------
    def record(self, name: str, t0: float, t1: float) -> None:
        self.spans.setdefault(name, []).append((t0, t1))

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block as span ``name`` (also when it raises)."""
        t0 = time.perf_counter()
        try:
            if self._profiling:
                import torch

                with torch.profiler.record_function(RANGE + name):
                    yield
            else:
                yield
        finally:
            self.record(name, t0, time.perf_counter())

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of ``obj.attr`` (a bound method) as span ``name``
        while the window is open; the instance's attribute shadows the
        class's, so nothing of the program is edited."""
        inner = getattr(obj, attr)

        def timed(*args, **kw):
            if not self.window_open:
                return inner(*args, **kw)
            with self.span(name):
                return inner(*args, **kw)

        setattr(obj, attr, timed)

    def in_window(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for a, b in self.spans.get(name, ())
                if a >= self.t_open and b <= self.t_close]

    # -- the traced stretch ------------------------------------------------
    def warm_trace(self) -> None:
        """Bring the profiler up once during set-up (its first start takes
        seconds), so that the traced stretch starts at once."""
        if not self.trace or self.device != "cuda":
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(8, device="cuda").add_(1)
            self.sync()
        gc.collect()

    def start_trace(self) -> None:
        if not self.trace or self._prof is not None or self.device != "cuda":
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self._counts0 = kernel_counts()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._stretch = torch.profiler.record_function(RANGE + "stretch")
        self._stretch.__enter__()
        self._profiling = True

    def stop_trace(self) -> None:
        if self._prof is None or self.trace_data is not None:
            return
        import torch

        self.sync()
        self._stretch.__exit__(None, None, None)
        self._profiling = False
        self._prof.__exit__(None, None, None)
        self.counters["traced"] = counts_since(self._counts0, kernel_counts())
        cuda = torch.autograd.DeviceType.CUDA
        kernels, ranges, stretch = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    kernels.append((name, e.start_ns(), e.end_ns()))
            elif name == RANGE + "stretch":
                stretch = (e.start_ns(), e.end_ns())
            elif name.startswith(RANGE):
                ranges.append((name[len(RANGE):], e.start_ns(), e.end_ns()))
        self._prof = None
        self._stretch = None
        gc.collect()  # the profiler's results sit in a reference cycle
        if stretch is not None and kernels:
            self.trace_data = Trace(kernels, ranges, *stretch)

    @property
    def tracing(self) -> bool:
        return self._profiling
