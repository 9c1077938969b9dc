"""An open loop of job arrivals into the long-lived auction service.

``JasdaService`` serves a Poisson stream of jobs (the cell's rate, work,
memory and deadline ranges; the cell's pool of jobs in the order the seed
permutes them) on the configuration's pod.  Its rounds fire every ``round_dt`` of simulated time and run back to
back on the host's clock.  The service runs in ONE ``run`` call, to a
horizon far past the window: a second call finds no round tick left
(the tick past the first horizon is popped and dropped).  The window
opens at the first round at or after ``warmup_t`` simulated seconds
(the initial burst is set-up) and closes after the first round that ends
``--seconds`` later; the rounds after it return without running.

End to end: ``round_ms`` (the window's wall over its rounds, the event
loop included) and ``round_p95_ms`` (the 95th percentile of the window's
round spans).
"""
from __future__ import annotations

import numpy as np

from bench import auction
from bench.auction import control  # noqa: F401  (bench/control.py)
from bench.traffic.jobs import PoissonJobs


class _Arrivals:
    """The program's arrival-process interface over the frozen stream."""

    def __init__(self, jobs: PoissonJobs):
        self.jobs = jobs

    def take_until(self, t: float):
        from repro_torch.core.trp import fmp_standard
        from repro_torch.core.types import JobSpec
        from repro_torch.service.arrivals import DeadlineExpired, JobArrival

        out = []
        for kind, rec, when in self.jobs.take_until(t):
            if kind == "arrive":
                s = rec.steady_bytes
                spec = JobSpec(job_id=rec.job_id, arrival_time=rec.t,
                               total_work=rec.work,
                               fmp=fmp_standard(0.3 * s, s, 0.1 * s,
                                                rel_sigma=0.03),
                               qos_deadline=rec.deadline)
                out.append(JobArrival(when, spec))
            else:
                out.append(DeadlineExpired(when, rec.job_id))
        return out


class _SteadyOf(dict):
    """job id -> steady memory, read from the stream as jobs are drawn."""

    def __init__(self, jobs: PoissonJobs):
        super().__init__()
        self.jobs = jobs

    def __missing__(self, job_id):
        for rec in self.jobs.jobs[len(self):]:
            self[rec.job_id] = rec.steady_bytes
        return dict.__getitem__(self, job_id)


def run(h) -> dict:
    import torch

    from repro_torch import core, service

    p = h.params
    cfg = h.config
    slices = auction.pod_slices(cfg, core.SliceSpec)
    sched = core.JasdaScheduler(slices, auction.scheduler_config(cfg, p, h.device))
    jobs = PoissonJobs(p["rate"], seed=h.seed, pool_seed=p["pool_seed"],
                       pool_size=p["pool_size"],
                       work_range=p["work_range"],
                       mem_range_gb=p["mem_range_gb"],
                       qos_fraction=p["qos_fraction"],
                       deadline_slack=p["deadline_slack"])
    svc = service.JasdaService(
        sched, _Arrivals(jobs),
        config=service.ServiceConfig(
            round_dt=p["round_dt"], t_end=p["horizon"], seed=0,
            max_bucket_m=p["max_bucket_m"], pipeline=p["pipeline"],
            keep_award_log=False),
        admission=service.AcceptAll())
    rec = auction.RoundRecorder(
        h, _SteadyOf(jobs), {s.slice_id: s.capacity_bytes for s in slices})
    rec.attach(sched)
    undo = rec.hook_scoring()
    from repro_torch.kernels.wis_dp import kernel as k2

    state = {"closed": False, "k2": 0}
    tick = svc._on_tick

    def on_tick(now, horizon, pipe):
        if state["closed"]:
            return  # the window is over: no more rounds
        if h.t_open is None and now >= p["warmup_t"]:
            h.open_window()
            state["k2"] = k2.LAUNCHES["wis_batch"]
            h.start_trace()
        tick(now, horizon, pipe)
        if h.window_open:
            if h.elapsed() >= h.seconds:
                h.close_window()
                state["closed"] = True
                state["k2"] = k2.LAUNCHES["wis_batch"] - state["k2"]

    svc._on_tick = on_tick
    h.warm_trace()
    try:
        svc.run(p["horizon"])
    finally:
        undo()
    if not state["closed"]:
        raise RuntimeError("the service reached its horizon inside the window")
    h.read_peak()
    failed_backends = sched.backend_health.failed_backends()
    spans = h.in_window("round")
    n = rec.n_rounds
    h.counters.update(rounds=n, k2_launches=state["k2"])
    del svc, sched
    if h.device == "cuda":
        torch.cuda.empty_cache()
    checks = auction.check(h, rec, auction.policy_of(cfg))
    ms = np.asarray([(b - a) * 1e3 for a, b in spans])
    return {
        "e2e": {"round_ms": 1e3 * h.window_s / n,
                "round_p95_ms": float(np.percentile(ms, 95))},
        "attempted": n, "failed": len(failed_backends),
        "checks": checks,
    }
