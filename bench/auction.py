"""What the auction drivers share: the pod, the round spans, the capture
of each round's inputs and outputs on the timed path, and the check.

A round's span runs from the first call into the scheduler's round
(``_prepare_round``, ``_finalize_prep`` or ``_settle_round``) to the end of
its ``_settle_round``, which commits the awards; under the pipeline the
speculative preparation of the next round is inside it, as the pipeline
runs it.  The calls are wrapped on the scheduler object built for the
run.  The scoring launch's operands are read where the program hands
them to ``score_variants`` and kept on the score handle the program makes
of that launch (pass-through wrappers on the program's module attributes,
for the run only), so that a round finds its own launch however many
came between.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from bench.reference import auction as ref

GB = 1 << 30


def pod_slices(config: dict, SliceSpec) -> list:
    """The configuration's slices: every card cut by its MIG profiles."""
    dep = config["deployment"]
    return [SliceSpec(f"gpu{g:02d}-{p['name']}", p["capacity_gb"] * GB,
                      n_chips=p["units"])
            for g in range(dep["cards"]) for p in dep["mig_profiles"]]


def scheduler_config(config: dict, params: dict, device: str):
    """The configuration's scheduler on ``device`` (the CPU runs the
    kernels' plain versions), re-verifying each bid against its agent's
    theta where the cell asks for it."""
    from repro_torch import core
    from repro_torch.core.scheduler import SchedulerConfig

    impl = config["scheduler"]["impl"] if device == "cuda" else "torch"
    return SchedulerConfig.from_policy(
        core.Policy(per_agent_theta=params["per_agent_theta"]),
        score_impl=impl, wis_impl=impl, device=device)


class RoundRecorder:
    """Round spans and, for every round of the window that scored bids,
    what the round took in and gave out."""

    def __init__(self, h, steady_of: Dict[str, float], slice_cap: Dict[str, float]):
        self.h = h
        self.steady_of = steady_of  # job id -> steady memory (bench traffic)
        self.slice_cap = slice_cap  # slice id -> capacity (bench config)
        self.rounds: List[dict] = []
        self.n_rounds = 0  # rounds committed while the window was open
        self.n_scored = 0  # ... of which scored bids on the device
        self._start = None
        self._range = None  # the profiler range of the round in flight
        self.on_round = None  # driver hook after each committed round

    # -- wiring -------------------------------------------------------
    def attach(self, sched) -> None:
        for attr in ("_prepare_round", "_finalize_prep"):
            inner = getattr(sched, attr)
            setattr(sched, attr, self._entry(inner))
        settle = sched._settle_round
        sched._settle_round = lambda prep: self._settle(settle, prep)

    def hook_scoring(self):
        """Keep the operands of every scoring launch on the score handle
        made of its result (``bench_launch``; the handle drops its device
        tensor once it is copied to the host, so a round cannot look its
        launch up by the tensor); returns the undo."""
        from repro_torch.core import scoring
        from repro_torch.kernels.jasda_score import ops

        inner, handle = ops.score_variants, scoring.ScoreHandle
        last = {}

        def recorded(fj, fs, alphas, betas, mu, sg, **kw):
            out = inner(fj, fs, alphas, betas, mu, sg, **kw)
            last["launch"] = (out[0], (fj, fs, mu, kw))
            return out

        class KeptHandle(handle):
            def __init__(self, scores, m=None):
                super().__init__(scores, m)
                got = last.pop("launch", None)
                self.bench_launch = (got[1] if got is not None
                                     and got[0] is scores else None)

        def undo():
            ops.score_variants = inner
            scoring.ScoreHandle = handle

        ops.score_variants = recorded
        scoring.ScoreHandle = KeptHandle
        return undo

    def _begin(self) -> None:
        if self._start is None:
            self._start = time.perf_counter()
            if self.h.window_open and self.h.tracing:
                import torch

                self._range = torch.profiler.record_function("bench:round")
                self._range.__enter__()

    def _entry(self, inner):
        def call(*a, **kw):
            self._begin()
            return inner(*a, **kw)
        return call

    def _settle(self, inner, prep):
        h = self.h
        self._begin()
        start, self._start = self._start, None
        handle = prep.handle
        sample = h.window_open and handle is not None and bool(prep.windows)
        launch = getattr(handle, "bench_launch", None) if sample else None
        rr = inner(prep)
        end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if h.window_open and prep.windows:
            h.record("round", start, end)
            self.n_rounds += 1
            self.n_scored += sample
            if launch is not None:
                self.rounds.append(self._capture(prep, rr, launch))
        if self.on_round is not None:
            self.on_round(prep.now)
        return rr

    def _capture(self, prep, rr, launch) -> dict:
        fj, fs, mu, kw = launch
        view = prep.view
        grids = not np.isscalar(kw["theta"])
        return {
            "windows": np.asarray([(self.slice_cap[w.slice_id], w.t_min,
                                    w.duration) for w in prep.windows]),
            "win_idx": np.asarray(prep.win_idx, np.intp),
            "t_start": view.t_start, "t_end": view.t_end,
            "job_ids": list(view.job_ids),
            "work": np.asarray([float(v.payload["work"]) if v.payload else 0.0
                                for v in prep.fit]),
            "budget": dict(prep.budget),
            "steady": np.asarray([self.steady_of[j] for j in view.job_ids]),
            "grid": int(mu.shape[1]) if grids else 32,
            "h": np.asarray(fj, np.float64)[:, 0],
            "age": np.asarray(fs, np.float64)[:, 3],
            "theta": np.asarray(kw["theta"], np.float64) if grids else None,
            "scores": np.asarray(prep.handle.result(), np.float64),
            "awards": [list(s) for s in rr.selected_idx],
        }


def check(h, recorder: RoundRecorder, policy: dict) -> dict:
    """The reference's verdict over every captured round (kept on the
    harness as ``h.captured`` for the control)."""
    h.captured = recorder.rounds
    worst = {"score_gap": 0.0, "award_gap": 0.0, "violations": 0}
    for rnd in recorder.rounds:
        got = ref.judge(rnd, policy)
        worst["score_gap"] = max(worst["score_gap"], got["score_gap"])
        worst["award_gap"] = max(worst["award_gap"], got["award_gap"])
        worst["violations"] += got["violations"]
    checks = {name: {"value": worst[name], "limit": h.limits[name]}
              for name in ("score_gap", "award_gap", "violations")}
    # every round of the window that scored bids is checked, and at least one
    checks["rounds_unchecked"] = {
        "value": max(recorder.n_scored, 1) - len(recorder.rounds), "limit": 0}
    return checks


def policy_of(config: dict) -> dict:
    return config["scheduler"]["policy"]


def control(h) -> dict:
    """The control's numbers over the rounds the run captured: the
    reference in the program's place, its scores in bfloat16 (the precision
    below the kernel's float32), settled on its own scores."""
    import torch

    pol = policy_of(h.config)
    worst = {"score_gap": 0.0, "award_gap": 0.0, "violations": 0}
    for rnd in h.captured:
        got = ref.control(rnd, pol, torch.bfloat16)
        worst["score_gap"] = max(worst["score_gap"], got["score_gap"])
        worst["award_gap"] = max(worst["award_gap"], got["award_gap"])
        worst["violations"] += got["violations"]
    return worst
