"""JasdaExecutor: the paper's interaction cycle driving REAL training jobs.

The port's copy of ``repro/core/executor.py``, on the port's scheduler,
health monitor and TRP; the steps a job runs are the port's torch train
steps (``launch/train.py``).

This is the integration layer that makes JASDA a first-class feature of the
framework rather than a simulation: training runs are registered as jobs,
atomized into step-chunks, bid into announced windows, and EXECUTED (real
train steps).  Measured wall time feeds the §4.2.1 ex-post verification
(ρ_J, HistAvg driven by real observations), and every chunk boundary is a
checkpoint — fault tolerance falls out of atomization (the SJA thesis).

Single-host realization: slices are executor lanes sharing this host's
device; chunks execute sequentially in committed-start order while the
schedule bookkeeping stays per-slice.  On a cluster, lanes map to mesh
partitions and chunks launch remotely; the control flow is identical.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..runtime import trace
from ..runtime.monitor import HealthMonitor
from .jobs import AgentConfig, JobAgent
from .scheduler import JasdaScheduler
from .trp import fmp_from_model
from .types import JobSpec, Variant

__all__ = ["TrainingJob", "JasdaExecutor"]


@dataclass
class TrainingJob:
    """A real training run: step_fn advances `steps` and returns metrics."""

    job_id: str
    total_steps: int
    step_fn: Callable[[int, int], Dict[str, float]]  # (start, n) -> metrics
    checkpoint_fn: Optional[Callable[[int], None]] = None
    # memory accounting for the FMP (bytes)
    param_bytes: float = 0.0
    optimizer_bytes: float = 0.0
    activation_bytes: float = 0.0
    # throughput declaration (steps/sec); calibrated from observations
    steps_per_sec: float = 1.0
    qos_deadline: Optional[float] = None
    steps_done: int = 0
    metrics_log: List[Dict[str, float]] = field(default_factory=list)


class JasdaExecutor:
    def __init__(self, scheduler: JasdaScheduler, *,
                 monitor: Optional[HealthMonitor] = None):
        self.scheduler = scheduler
        self.monitor = monitor or HealthMonitor()
        for sid in scheduler.slices:
            self.monitor.register(sid, now=0.0)
        self.jobs: Dict[str, TrainingJob] = {}
        self._t0 = time.perf_counter()

    # -- clock ----------------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self._t0

    # -- registration --------------------------------------------------------
    def register(self, job: TrainingJob, *, agent_cfg: AgentConfig = AgentConfig(),
                 atomizer=None) -> None:
        fmp = fmp_from_model(
            param_bytes=job.param_bytes,
            optimizer_bytes=job.optimizer_bytes,
            activation_bytes=job.activation_bytes,
        )
        spec = JobSpec(
            job_id=job.job_id,
            arrival_time=self.now(),
            total_work=float(job.total_steps),
            fmp=fmp,
            qos_deadline=job.qos_deadline,
        )
        agent = _TrainingAgent(spec, job, agent_cfg, atomizer) if atomizer else \
            _TrainingAgent(spec, job, agent_cfg)
        self.jobs[job.job_id] = job
        self.scheduler.add_job(agent, self.now())

    # -- main loop ------------------------------------------------------------
    def run(self, *, max_wall: float = 300.0, idle_exit: float = 5.0) -> None:
        """Drive the interaction cycle until jobs finish or wall limit."""
        last_progress = self.now()
        pending: List[Variant] = []
        while self.now() < max_wall:
            now = self.now()
            with trace.span("executor.round", now=now):
                result = self.scheduler.step(now)
            if result and result.selected:
                pending.extend(result.selected)
                last_progress = self.now()

            # execute the next committed chunk whose start has arrived
            pending.sort(key=lambda v: v.t_start)
            ran = False
            for v in list(pending):
                if v.t_start <= self.now() + 1e-6:
                    pending.remove(v)
                    with trace.span("executor.chunk", job_id=v.job_id,
                                    slice_id=v.slice_id):
                        self._execute(v)
                    ran = True
                    last_progress = self.now()
                    break
            if not ran and not (result and result.selected):
                if all(j.steps_done >= j.total_steps for j in self.jobs.values()):
                    return
                if self.now() - last_progress > idle_exit:
                    with trace.span("executor.idle"):
                        time.sleep(0.01)

    # -- chunk execution --------------------------------------------------------
    def _execute(self, v: Variant) -> None:
        job = self.jobs[v.job_id]
        n_steps = max(1, int(round(v.payload["work"])))
        n_steps = min(n_steps, job.total_steps - job.steps_done)
        t_start = time.perf_counter()
        metrics = job.step_fn(job.steps_done, n_steps)
        wall = time.perf_counter() - t_start
        job.steps_done += n_steps
        job.metrics_log.append({"steps": n_steps, "wall": wall, **(metrics or {})})
        if job.checkpoint_fn is not None:
            job.checkpoint_fn(job.steps_done)  # chunk boundary = checkpoint

        # ex-post verification with REAL measurements (paper §4.2.1)
        declared = dict(v.declared_features)
        ratio = float(np.clip(v.duration / max(wall, 1e-9), 0.0, 1.0))
        observed = {k: float(np.clip(val * ratio, 0.0, 1.0)) if k in ("jct",)
                    else val for k, val in declared.items()}
        self.scheduler.complete(
            v, observed, work_done=float(n_steps),
            actual_end=v.t_start + wall)
        self.monitor.heartbeat(
            v.slice_id, now=self.now(),
            observed_speed=float(np.clip(v.duration / max(wall, 1e-9), 0.0, 2.0)))


class _TrainingAgent(JobAgent):
    """JobAgent whose throughput model tracks the job's measured step rate."""

    def __init__(self, spec: JobSpec, job: TrainingJob, cfg: AgentConfig,
                 atomizer=None):
        from .atomizer import AtomizerConfig
        super().__init__(spec, cfg, atomizer or AtomizerConfig(
            tau_min=0.5, activation_cost=0.1, max_variants_per_window=3))
        self._job = job

    def throughput_on(self, capacity: float, n_chips: int = 1) -> float:
        if capacity < self.spec.min_capacity:
            return 0.0
        if self._job.metrics_log:
            recent = self._job.metrics_log[-4:]
            sps = sum(m["steps"] for m in recent) / max(
                sum(m["wall"] for m in recent), 1e-9)
            return float(sps)
        return float(self._job.steps_per_sec)
