"""The jamba cell (``jamba2-mini-ep2.docs32``) at its CPU size: its
comparison catches a broken timed path and fails the control, and its
per-layer readers read what the program gives them.

Each fault breaks the program underneath a run and must come out not
correct: the layer computing every expert's choices (the absent experts'
by the held ones' weights) in place of its own share's, and the mixers
skipping their dt/B/C norms.  The mixer's chunks are cut to 8 tokens
here (2048 on the card), so that the prompts of 8-24 tokens run the
chunked prefill."""
import types

import pytest
import torch

from bench import harness
from bench.counts import jamba as counts
from bench.tests.small import run_small

CELL = "jamba2-mini-ep2.docs32"


@pytest.fixture(autouse=True)
def short_chunks(monkeypatch):
    from repro_torch.models import ssm

    monkeypatch.setattr(ssm, "CHUNK", 8)


@pytest.fixture(scope="module")
def traced():
    """One traced run with the program's spans on, which the control and
    the readers both read (on two threads, as ``few_threads`` sets)."""
    from repro_torch.models import ssm
    from repro_torch.runtime import trace

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp, trace.enable():
            mp.setattr(ssm, "CHUNK", 8)
            trace.reset()
            return run_small(CELL, seed=43, trace=1)
    finally:
        trace.reset()
        torch.set_num_threads(before)


def test_control_fails_the_limit(traced):
    result, h = traced
    assert result["correct"], result["checks"]
    ctl = harness.driver(h.cell["driver"]).control(h)
    for k in ("logit_gap", "logit_gap_mean"):
        assert ctl[k] > h.limits[k], (ctl, h.limits)


def _every_expert(monkeypatch):
    from repro_torch.models import model

    inner = model.moe_dropless

    def broken(x, p, *, top_k, held, **kw):
        first, n = held
        whole = {k: (v if k == "router" else torch.cat([v, v]))
                 for k, v in p.items()}
        return inner(x, whole, top_k=top_k, held=(0, 2 * n), **kw)

    monkeypatch.setattr(model, "moe_dropless", broken)


def _no_mixer_norms(monkeypatch):
    from repro_torch.models import ssm

    monkeypatch.setattr(ssm, "rms_norm", lambda x, scale, eps: x)


@pytest.mark.parametrize("fault", [_every_expert, _no_mixer_norms],
                         ids=["every_expert", "no_mixer_norms"])
def test_faults_are_caught(monkeypatch, fault):
    fault(monkeypatch)
    result, h = run_small(CELL, seed=42)
    assert not result["correct"], result["checks"]
    checks = result["checks"]
    assert checks["requests_unchecked"]["value"] == 0, checks
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"], checks


def test_readers_find_the_program_counts_and_spans(traced):
    result, h = traced
    m = result["metrics"]
    assert result["correct"], result["checks"]
    # 4 of 8 experts held: a random router sends them about half
    assert 25 < m["moe_held_pct"]["value"] < 75
    assert 1 <= m["moe_load_max"]["value"] < 4
    assert h.counters["stretch_prefills"] >= 1
    assert sum(h.counters["routed"]) > 0
    # the card's trace alone
    assert "k4_roofline_pct" not in m and "moe_prefill_ms" not in m


class _Event:
    def __init__(self, name, start, end, corr=0, linked=0, cuda=False,
                 annotation=False):
        self._v = (name, start, end, corr, linked, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]

    def device_type(self):
        t = torch.autograd.DeviceType
        return t.CUDA if self._v[5] else t.CPU

    def is_user_annotation(self):
        return self._v[6]


def test_moe_device_time_counts_what_the_moe_ranges_launched():
    """Device activities belong to the host op that launched them, and the
    op to the ``model.moe`` range that holds its start: a kernel that runs
    late still counts, another layer's kernel that runs inside the range's
    time does not, nor does the range's own device annotation."""
    from bench.drivers.engine_jamba import moe_device_s

    ev = [_Event("engine.prefill", 0, 1000, corr=1),
          _Event("model.moe", 100, 200, corr=2, annotation=True),
          _Event("aten::mm", 110, 120, corr=3),
          _Event("aten::sort", 130, 140, corr=4),
          _Event("aten::mm", 300, 310, corr=5),  # the next layer's
          _Event("gemm", 150, 400, linked=3, cuda=True),
          _Event("sort_kernel", 400, 450, linked=4, cuda=True),
          _Event("launched_by_the_range", 450, 460, linked=2, cuda=True),
          _Event("gemm", 160, 190, linked=5, cuda=True),
          _Event("model.moe", 150, 460, linked=2, cuda=True, annotation=True)]
    s, prefills = moe_device_s(ev)
    assert prefills == 1
    assert s == pytest.approx((250 + 50 + 10) / 1e9)
    h = types.SimpleNamespace(counters={"moe_prefill_device_s": 2e-3,
                                        "moe_prefills": 4})
    read = harness.metric_reader("moe_prefill_ms").read
    assert read({"h": h}) == pytest.approx(0.5)
    assert read({"h": types.SimpleNamespace(counters={})}) is None


def _k4(shapes, kernels):
    h = types.SimpleNamespace(counters={"traced": {"flash_attention.shapes": shapes}})
    tr = harness.Trace(kernels, [], 0, 10**9)
    return harness.metric_reader("k4_roofline_pct").read({"h": h, "trace": tr})


def test_k4_roofline_reads_the_counted_launches():
    from bench.counts import kernels as kc

    shape = (1, 32, 8, 4096, 8512, 128, "bfloat16", True, None, 0)
    bound = kc.bound_s(*kc.k4(1, 32, 8, 4096, 8512, 128, True, None, 0, 2),
                       kc.BF16_FLOPS_PER_S)
    one = [("flash_attention_tc_kernel", 0, 2_000_000)]
    assert _k4({shape: 1}, one) == pytest.approx(100 * bound / 2e-3)
    assert _k4({shape: 2}, one) is None  # a launch the trace lacks
    assert _k4({}, [("other_kernel", 0, 10)]) is None


def test_model_flops_count_the_programs_active_parameters():
    from bench.drivers import engine_jamba

    for over in ({}, harness.load_json(
            harness.BENCH / "tests" / "sizes" / f"{CELL}.json")["params"]["config_overrides"]):
        h = types.SimpleNamespace(config=harness.config("jamba2-mini-ep2"),
                                  params={"config_overrides": over})
        c, cfg = engine_jamba.model_config(h)
        assert counts.active_params(c) == cfg.active_param_count()
