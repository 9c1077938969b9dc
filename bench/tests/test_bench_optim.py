"""The optimizer's two readers: ``adamw_roofline_pct`` on a synthetic
trace against the frozen count (``bench/counts/optim.py``), and
``optim_fused_pct`` on the program's ``train.optimizer`` spans."""
import time
import types

import pytest

from bench import harness
from bench.counts import kernels, model, optim
from bench.tests.small import run_small

CELL = "falcon-mamba-7b-32l.train-jasda"


def _read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def test_bytes_of_a_bfloat16_and_a_float32_leaf():
    assert optim.leaf_bytes(1000, 2) == 22 * 1000
    assert optim.leaf_bytes(1000, 4) == 28 * 1000
    assert optim.leaf_bytes(1000, 4, 2) == 26 * 1000


def test_the_train_cells_step_bytes():
    c = harness.config("falcon-mamba-7b-32l")
    leaves = optim.ssm_leaves(c)
    assert leaves["in_proj"] == 2**31
    # the model count leaves out the norms, the conv bias and dt's bias
    small = ("final_norm", "ln1_scale", "conv_b", "dt_bias")
    assert sum(n for k, n in leaves.items() if k not in small) == \
        model.ssm_params(c)
    f32 = sum(leaves[k] for k in c["float32_leaves"])
    assert f32 == 4_853_760
    assert optim.step_bytes(c) == 22 * (sum(leaves.values()) - f32) + 28 * f32
    assert 1e3 * kernels.bound_s(optim.step_bytes(c), 0) == \
        pytest.approx(25.6657, rel=1e-5)


def _ctx(kernels_, steps, overrides=None):
    cfg = harness.config("falcon-mamba-7b-32l")
    h = types.SimpleNamespace(config=cfg, params={"config_overrides":
                                                  overrides or {}})
    ranges = [("step", a, b) for a, b in steps] + [("chunk", 0, 10**9)]
    return {"h": h, "out": {}, "trace": harness.Trace(kernels_, ranges, 0, 10**9)}


def test_roofline_counts_the_kernels_inside_the_steps():
    bound = kernels.bound_s(optim.step_bytes(harness.config(
        "falcon-mamba-7b-32l")), 0)
    ns = int(bound * 1e9)
    trace = [
        ("void (anonymous namespace)::grad_sumsq_kernel<__nv_bfloat16>", 100, 100 + ns // 10),
        ("void (anonymous namespace)::grad_sumsq_finish_kernel", 200, 300),
        ("void (anonymous namespace)::adamw_update_kernel<__nv_bfloat16, __nv_bfloat16>",
         1000, 1000 + ns),
        ("void (anonymous namespace)::adamw_update_kernel<float, float>", 10**8, 10**8 + ns),
        ("linear_scan_kernel", 2000, 10**7),
        # outside every step range: not counted
        ("void (anonymous namespace)::adamw_update_kernel<float, float>", 5 * 10**8, 6 * 10**8),
    ]
    ctx = _ctx(trace, [(0, 10**7), (10**8 - 5, 2 * 10**8)])
    t = ns // 10 + 100 + 2 * ns
    assert _read("adamw_roofline_pct", ctx) == pytest.approx(
        100.0 * 2 * bound / (t / 1e9), rel=1e-12)


def test_roofline_reads_nothing_without_the_kernels():
    ctx = _ctx([("MulFunctor", 0, 10**6), ("DivFunctor", 10, 10**5)],
               [(0, 10**7)])
    assert _read("adamw_roofline_pct", ctx) is None
    assert _read("adamw_roofline_pct", dict(ctx, trace=None)) is None


def test_fused_share_over_mixed_spans():
    from repro_torch.runtime import trace

    trace.reset()
    with trace.enable():
        t_open = time.perf_counter()
        for elems, fused in ((100, 100), (300, 0), (0, 0)):
            with trace.span("train.optimizer") as sp:
                sp.attrs.update(impl="cuda" if fused else "torch",
                                elems=elems, fused_elems=fused)
        with trace.span("executor.round"):
            pass
        t_close = time.perf_counter()
    h = types.SimpleNamespace(t_open=t_open, t_close=t_close)
    assert _read("optim_fused_pct", {"h": h, "out": {}, "trace": None}) == 25.0
    trace.reset()
    with trace.enable():
        with trace.span("executor.round"):
            pass
    assert _read("optim_fused_pct", {"h": h, "out": {}, "trace": None}) is None
    trace.reset()


def test_fused_share_of_a_cpu_run_is_zero():
    """The cell on the CPU runs the plain path: its spans say so."""
    from repro_torch.runtime import trace

    trace.reset()
    with trace.enable():
        result, h = run_small(CELL, seed=2**31 + 41, trace=1)
    assert result["correct"], result["checks"]
    assert result["metrics"]["optim_fused_pct"]["value"] == 0.0
    spans = [s for s in trace.spans() if s.name == "train.optimizer"]
    trace.reset()
    assert spans and {s.attrs["impl"] for s in spans} == {"torch"}
