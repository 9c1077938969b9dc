"""The executor, the training launcher, the baselines and the padded WIS of
the port against the JAX package.

* ``JasdaExecutor`` drives real jobs: the mirror of
  ``tests/test_serving_runtime.py::test_executor_runs_real_jobs_to_completion``,
  and reduced falcon-mamba-7b trained under it gives, bit for bit on the
  CPU, the losses of the same steps in a plain loop (a step is a function
  of its index);
* ``launch.train --reduced --device cpu`` runs and checkpoints;
* the four baseline schedulers give the reference's summaries on
  ``tests/test_scheduler_sim.py``'s workloads (numpy only: identical);
* ``core.wis.wis_select_jax`` (the torch twin, ``wis_select_torch``) gives
  the reference's masks and float32 totals on ``tests/test_wis.py``'s
  seeded pools.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from repro.core import SimConfig as RefSimConfig
from repro.core import SliceSpec as RefSliceSpec
from repro.core import make_workload as ref_make_workload
from repro.core import simulate as ref_simulate
from repro.core import baselines as ref_baselines
from repro.core.wis import wis_select, wis_select_jax as ref_wis_select_jax
from repro_torch.configs import reduced
from repro_torch.core import (AuctionScheduler, BackfillScheduler,
                              BestFitScheduler, FifoScheduler, JasdaScheduler,
                              SimConfig, SliceSpec, make_workload, simulate)
from repro_torch.core.executor import JasdaExecutor, TrainingJob
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.windows import WindowPolicy
from repro_torch.core.wis import wis_select_jax, wis_select_torch
from repro_torch.launch import train as train_launcher

GB = 1 << 30


def test_executor_runs_real_jobs_to_completion():
    sched = JasdaScheduler(
        [SliceSpec("lane0", 8 * GB, n_chips=1)],
        SchedulerConfig(window=WindowPolicy(horizon=60.0, min_gap=0.2),
                        device="cpu"))
    ex = JasdaExecutor(sched)
    calls = []

    def step_fn(start, n):
        calls.append((start, n))
        return {"loss": 1.0 / (start + n)}

    ckpts = []
    job = TrainingJob(job_id="J", total_steps=25, step_fn=step_fn,
                      checkpoint_fn=lambda s: ckpts.append(s),
                      param_bytes=1e6, optimizer_bytes=1e6,
                      activation_bytes=1e6, steps_per_sec=100.0)
    ex.register(job)
    ex.run(max_wall=30.0)
    assert job.steps_done >= 25
    assert ckpts, "chunk boundaries must checkpoint"
    covered = sum(n for _, n in calls)
    assert covered >= 25
    # chunks are contiguous from 0, and each boundary checkpoints
    assert [s for s, _ in calls] == [0] + [s + n for s, n in calls[:-1]]
    assert ckpts == [s + n for s, n in calls]
    assert len(job.metrics_log) == len(calls)


def test_executor_losses_equal_a_plain_loop_bit_for_bit():
    cfg = reduced("falcon_mamba_7b")
    kw = dict(optimizer="adamw", steps=6, batch=4, seq=32, device="cpu")
    boundaries = []
    under = train_launcher.train(
        cfg, jasda=True, checkpoint_fn=lambda s, state: boundaries.append(
            (s, sorted(state))), **kw)
    plain = train_launcher.train(cfg, jasda=False, **kw)
    assert under.losses == plain.losses
    assert under.grad_norms == plain.grad_norms
    assert [i for s, n in under.chunks for i in range(s, s + n)] == list(range(6))
    assert boundaries == [(s + n, ["opt", "params"]) for s, n in under.chunks]
    for a, b in zip(train_launcher._leaves(under.state),
                    train_launcher._leaves(plain.state)):
        assert torch.equal(a, b)
    assert all(np.isfinite(under.losses))


def test_train_launcher_runs_on_the_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_launcher.main(["--arch", "falcon_mamba_7b", "--reduced",
                             "--device", "cpu", "--steps", "4", "--batch", "2",
                             "--seq", "16", "--ckpt-dir", str(tmp_path)])
    out = buf.getvalue().splitlines()
    losses = json.loads(next(x for x in out if x.startswith("losses: "))[8:])
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert out[-1].startswith("done: loss")
    assert "checkpoints at [4]" in out[-1]
    assert (tmp_path / "step_4").is_dir()


def test_train_launcher_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--arch", "falcon_mamba_7b", "--reduced",
                             "--steps", "1"])


# ---------------------------------------------------------------------------
# baselines: the reference's summaries on test_scheduler_sim.py's workloads
# ---------------------------------------------------------------------------

BASELINES = ["FifoScheduler", "BackfillScheduler", "BestFitScheduler",
             "AuctionScheduler"]
PORT_BASELINES = {"FifoScheduler": FifoScheduler,
                  "BackfillScheduler": BackfillScheduler,
                  "BestFitScheduler": BestFitScheduler,
                  "AuctionScheduler": AuctionScheduler}


def _slices(spec, n=3, cap_gb=20, chips=4):
    return [spec(f"s{k}", cap_gb * GB, n_chips=chips) for k in range(n)]


def _hetero(spec):
    return [spec("s20", 20 * GB, n_chips=4), spec("s10", 10 * GB, n_chips=2)] + \
        [spec(f"s5{i}", 5 * GB, n_chips=1) for i in range(4)]


WORKLOADS = {
    # test_baseline_completes_workload
    "completes": (_slices, dict(n=20, seed=4, arrival_rate=0.5),
                  dict(t_end=3000.0, seed=2)),
    # test_jasda_beats_fifo_under_heterogeneity
    "heterogeneous": (_hetero, dict(n=120, seed=1, arrival_rate=0.25,
                                    mem_range_gb=(1.0, 14.0)),
                      dict(t_end=6000.0, seed=2)),
}


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("name", BASELINES)
def test_baselines_give_the_reference_summaries(name, workload):
    slices, wl, sim = WORKLOADS[workload]
    wl = dict(wl)
    n = wl.pop("n")
    ref = ref_simulate(getattr(ref_baselines, name)(slices(RefSliceSpec)),
                       ref_make_workload(n, **wl), RefSimConfig(**sim))
    port = simulate(PORT_BASELINES[name](slices(SliceSpec)),
                    make_workload(n, **wl), SimConfig(**sim))
    assert port.summary() == ref.summary()
    assert port.n_finished == ref.n_finished
    if workload == "completes":
        assert port.n_finished == 20


# ---------------------------------------------------------------------------
# the padded, mask-based WIS (the reference's wis_select_jax)
# ---------------------------------------------------------------------------

def _random_pool(rng, m):
    starts = rng.uniform(0, 100, m)
    ends = starts + rng.uniform(0.5, 30, m)
    w = rng.uniform(0.0, 1.0, m)
    return starts, ends, w


@pytest.mark.parametrize("seed", range(12))
def test_wis_select_jax_twin_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for m in (1, 2, 5, 12):
        starts, ends, w = _random_pool(rng, m)
        valid = (rng.random(m) > 0.25) if seed % 2 else None
        mask_r, total_r = ref_wis_select_jax(starts, ends, w, valid)
        mask_p, total_p = wis_select_jax(starts, ends, w, valid)
        assert mask_p.dtype == torch.bool and total_p.dtype == torch.float32
        np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_r))
        assert float(total_p) == float(total_r)
        if valid is None:
            sel_h, total_h = wis_select(starts, ends, w)
            assert set(np.flatnonzero(mask_p.numpy()).tolist()) == set(sel_h.tolist())
            assert float(total_p) == pytest.approx(total_h, rel=1e-5)


def test_wis_select_jax_zero_length_intervals():
    """Zero-length intervals whose lanes the backtrack can leave: their
    preds lie past them, read dp's initial 0 as the reference does."""
    for starts, ends, w in [([0, 2, 2, 5], [2, 2, 6, 6], [1.0, 0.5, 2.0, 1.0]),
                            ([0, 1], [1, 1], [0.0, 0.0]),
                            ([3, 0, 3], [3, 3, 9], [0.1, 2.0, 4.0])]:
        mask_r, total_r = ref_wis_select_jax(starts, ends, w)
        mask_p, total_p = wis_select_torch(starts, ends, w)
        np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_r))
        assert float(total_p) == float(total_r)


def test_wis_select_jax_raises_where_the_reference_never_returns():
    """One taken zero-length interval [1, 1): its pred is its own lane, so
    the reference's backtrack ``while_loop`` revisits it forever; the twin
    raises (ROADMAP.md §3)."""
    with pytest.raises(ValueError, match="revisits lane"):
        wis_select_torch([1.0], [1.0], [1.0])
    with pytest.raises(ValueError, match="revisits lane"):
        wis_select_torch([0.0, 1.0], [1.0, 1.0], [0.5, 0.7])
