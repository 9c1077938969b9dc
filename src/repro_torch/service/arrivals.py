"""Seeded open-loop arrival processes for the streaming service.

The closed-loop simulator pre-draws every job before the run starts
(``make_workload``); production traffic does not work that way.  An
:class:`ArrivalProcess` is a LAZY, seeded stream: the service pulls the
events that fall inside each round interval (``take_until``) and pushes
them onto its :class:`~repro_torch.core.events.EventHeap`, so jobs arrive (and
cancel, and expire) while rounds are in flight.  The stream is a pure
function of its seed — two pulls with the same seed and the same
``take_until`` cut points yield byte-identical event sequences — and the
process object pickles with its generator state, so a service checkpoint
resumes the stream mid-draw without replaying it.

Three processes cover the paper-adjacent load shapes:

* :class:`PoissonArrivals` — memoryless open-loop load at a fixed rate.
* :class:`BurstArrivals` — a 2-state MMPP (Markov-modulated Poisson):
  exponential dwell times switch between a quiet rate and a burst rate.
* :class:`DiurnalArrivals` — sinusoidal rate modulation via Lewis–Shedler
  thinning (a day/night traffic trace).

Each arrival may carry side events drawn from the same generator: a QoS
deadline spawns a :class:`DeadlineExpired` event at the deadline, and a
``cancel_fraction`` coin spawns a :class:`JobCancel` mid-flight — both
delivered through the service's heap with the arrival-stream ordering.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np

from ..core.trp import fmp_standard
from ..core.types import JobSpec

__all__ = [
    "JobArrival",
    "JobCancel",
    "DeadlineExpired",
    "ArrivalProcess",
    "PoissonArrivals",
    "BurstArrivals",
    "DiurnalArrivals",
]

_GB = 1 << 30


@dataclass(frozen=True)
class JobArrival:
    """A new job enters the system at ``t``."""

    t: float
    spec: JobSpec


@dataclass(frozen=True)
class JobCancel:
    """The submitter withdraws the job at ``t`` (mid-flight)."""

    t: float
    job_id: str


@dataclass(frozen=True)
class DeadlineExpired:
    """The job's QoS deadline passes at ``t``; unfinished work is void."""

    t: float
    job_id: str


ArrivalEvent = Union[JobArrival, JobCancel, DeadlineExpired]


class ArrivalProcess:
    """Base class: seeded lazy stream of typed arrival-side events.

    Subclasses implement :meth:`_next_arrival` (the point process);
    everything else — job synthesis, side events, the monotone
    ``take_until`` cursor — is shared.  ``t_end`` truncates the stream:
    no ARRIVALS are drawn past it (side events of earlier arrivals may
    still land beyond it; the service's horizon cut discards those).
    """

    name = "base"

    def __init__(
        self,
        *,
        seed: int = 0,
        t_end: float = float("inf"),
        work_range: Tuple[float, float] = (10.0, 60.0),
        mem_range_gb: Tuple[float, float] = (2.0, 12.0),
        qos_fraction: float = 0.3,
        deadline_slack: Tuple[float, float] = (2.0, 6.0),
        cancel_fraction: float = 0.0,
        prefix: str = "S",
    ):
        self.seed = seed
        self.t_end = float(t_end)
        self.work_range = work_range
        self.mem_range_gb = mem_range_gb
        self.qos_fraction = qos_fraction
        self.deadline_slack = deadline_slack
        self.cancel_fraction = cancel_fraction
        self.prefix = prefix
        self.rng = np.random.default_rng(seed)
        self._n = 0  # jobs emitted (names stay dense per seed)
        self._stage_seq = 0  # deterministic equal-time ordering in staged
        self._last_t = 0.0  # time of the previous arrival
        self._next_t: Optional[float] = None  # drawn-ahead arrival time
        self._exhausted = False
        # side events (cancel/deadline) drawn alongside their arrival but
        # timestamped later; drained by take_until as their times pass
        self._staged: List[Tuple[float, int, ArrivalEvent]] = []

    # -- the point process (subclass hook) --------------------------------
    def _next_arrival(self, prev_t: float) -> float:
        """Absolute time of the next arrival after ``prev_t``."""
        raise NotImplementedError

    # -- shared machinery --------------------------------------------------
    def _stage(self, t: float, event: ArrivalEvent) -> None:
        self._staged.append((t, self._stage_seq, event))
        self._stage_seq += 1

    def _draw_job(self, ta: float) -> None:
        """Synthesize one job at ``ta`` plus its side events.

        Same distribution family as ``make_workload`` (log-uniform work,
        uniform steady memory, warmup/steady/spike FMP, uniform deadline
        slack) so closed-loop and open-loop scenarios stay comparable.
        """
        rng = self.rng
        i = self._n
        self._n += 1
        lo, hi = self.work_range
        work = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        steady = rng.uniform(*self.mem_range_gb) * _GB
        fmp = fmp_standard(0.3 * steady, steady, 0.1 * steady, rel_sigma=0.03)
        deadline = None
        if rng.uniform() < self.qos_fraction:
            deadline = ta + work * rng.uniform(*self.deadline_slack)
        job_id = f"{self.prefix}{i:04d}"
        spec = JobSpec(
            job_id=job_id,
            arrival_time=ta,
            total_work=work,
            fmp=fmp,
            qos_deadline=deadline,
        )
        self._stage(ta, JobArrival(ta, spec))
        if deadline is not None:
            self._stage(deadline, DeadlineExpired(deadline, job_id))
        if self.cancel_fraction > 0 and rng.uniform() < self.cancel_fraction:
            tc = ta + work * rng.uniform(0.5, 3.0)
            self._stage(tc, JobCancel(tc, job_id))

    def take_until(self, t: float) -> List[ArrivalEvent]:
        """All events with timestamp ≤ ``t``, in deterministic order.

        Advances the stream cursor; calls must pass non-decreasing ``t``
        (the service pulls once per round).  Events are ordered by
        ``(timestamp, draw order)`` so replays are byte-identical per
        seed regardless of the cut points.
        """
        while not self._exhausted:
            if self._next_t is None:
                nt = self._next_arrival(self._last_t)
                if nt > self.t_end:
                    self._exhausted = True
                    break
                self._next_t = nt
            if self._next_t > t:
                break
            self._last_t = self._next_t
            self._next_t = None
            self._draw_job(self._last_t)
        due = sorted(e for e in self._staged if e[0] <= t)
        self._staged = [e for e in self._staged if e[0] > t]
        return [ev for _, _, ev in due]

    @property
    def n_emitted(self) -> int:
        return self._n


class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals at a fixed ``rate`` (jobs per unit time)."""

    name = "poisson"

    def __init__(self, rate: float, **kw):
        super().__init__(**kw)
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)

    def _next_arrival(self, prev_t: float) -> float:
        return prev_t + self.rng.exponential(1.0 / self.rate)


class BurstArrivals(ArrivalProcess):
    """2-state MMPP: quiet/burst rates with exponential dwell times.

    The modulating chain starts quiet; rate switches are simulated
    exactly (an inter-arrival draw that crosses the switch point is
    re-drawn from the new state's rate starting at the switch), so the
    stream is a faithful Markov-modulated Poisson process, not a blend.
    """

    name = "burst"

    def __init__(
        self,
        rate_quiet: float,
        rate_burst: float,
        *,
        mean_dwell_quiet: float = 80.0,
        mean_dwell_burst: float = 20.0,
        **kw,
    ):
        super().__init__(**kw)
        if min(rate_quiet, rate_burst) <= 0:
            raise ValueError("both rates must be > 0")
        self.rate_quiet = float(rate_quiet)
        self.rate_burst = float(rate_burst)
        self.mean_dwell_quiet = float(mean_dwell_quiet)
        self.mean_dwell_burst = float(mean_dwell_burst)
        self._burst = False
        self._switch_t = self.rng.exponential(self.mean_dwell_quiet)

    def _next_arrival(self, prev_t: float) -> float:
        t = prev_t
        while True:
            rate = self.rate_burst if self._burst else self.rate_quiet
            candidate = t + self.rng.exponential(1.0 / rate)
            if candidate <= self._switch_t:
                return candidate
            # memorylessness: restart the draw at the switch point under
            # the new state's rate
            t = self._switch_t
            self._burst = not self._burst
            dwell = self.rng.exponential(
                self.mean_dwell_burst if self._burst else self.mean_dwell_quiet)
            self._switch_t = t + dwell


class DiurnalArrivals(ArrivalProcess):
    """Sinusoidal day/night load via Lewis–Shedler thinning.

    Instantaneous rate ``λ(t) = peak_rate · (floor + (1−floor) · ½(1 +
    sin(2πt/period + phase)))`` — candidates are drawn at ``peak_rate``
    and accepted with probability ``λ(t)/peak_rate``, the standard exact
    simulation of an inhomogeneous Poisson process.
    """

    name = "diurnal"

    def __init__(
        self,
        peak_rate: float,
        *,
        period: float = 500.0,
        floor: float = 0.2,
        phase: float = 0.0,
        **kw,
    ):
        super().__init__(**kw)
        if peak_rate <= 0:
            raise ValueError(f"peak_rate must be > 0, got {peak_rate}")
        if not 0.0 <= floor <= 1.0:
            raise ValueError(f"floor must be in [0, 1], got {floor}")
        self.peak_rate = float(peak_rate)
        self.period = float(period)
        self.floor = float(floor)
        self.phase = float(phase)

    def _rate_at(self, t: float) -> float:
        mod = 0.5 * (1.0 + np.sin(2.0 * np.pi * t / self.period + self.phase))
        return self.peak_rate * (self.floor + (1.0 - self.floor) * mod)

    def _next_arrival(self, prev_t: float) -> float:
        t = prev_t
        while True:
            t += self.rng.exponential(1.0 / self.peak_rate)
            if self.rng.uniform() * self.peak_rate <= self._rate_at(t):
                return t
