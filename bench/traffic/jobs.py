"""Job streams for the auction cells, drawn from a seed.

A frozen copy of the program's job generator, so that a later change to
the program cannot move the traffic: :class:`PoissonJobs` draws what
``repro_torch.service.arrivals.PoissonArrivals`` draws (exponential gaps,
log-uniform work, uniform steady memory, a QoS deadline for a share of
the jobs), number for number in the same order.

Every seed gets the same jobs in another order: the draws are made once
from the cell's ``pool_seed`` (gaps between arrivals, work, memory, the
deadline coin and slack), and the run's seed only permutes them, so that
a window holds about the same work whatever the seed.

It returns plain records.  The driver turns them into the program's job
objects, and the reference reads the same records (a job's memory profile
is ``fmp_standard(0.3 s, s, 0.1 s, rel_sigma=0.03)`` of its steady memory
``s``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

GB = 1 << 30


@dataclass(frozen=True)
class JobRecord:
    job_id: str
    t: float  # arrival time (simulated seconds)
    work: float  # total work units
    steady_bytes: float  # steady memory of the job's profile
    deadline: Optional[float]  # QoS deadline (absolute) or None


def _permuted(rows: list, seed: int) -> list:
    order = np.random.default_rng([seed, 3]).permutation(len(rows))
    return [rows[i] for i in order]


class PoissonJobs:
    """Memoryless arrivals at ``rate`` jobs per simulated second: a pool of
    ``pool_size`` jobs drawn from ``pool_seed``, in the order ``seed``
    permutes them (the pool again, permuted anew, once it runs out).

    ``take_until(t)`` returns the records of every arrival at or before
    ``t`` and every deadline at or before ``t``, in the order the
    program's ``ArrivalProcess.take_until`` gives them: by time, then by
    draw order (an arrival is staged before its own deadline).
    """

    def __init__(self, rate: float, *, seed: int, pool_seed: int,
                 pool_size: int,
                 work_range: Tuple[float, float] = (10.0, 60.0),
                 mem_range_gb: Tuple[float, float] = (2.0, 12.0),
                 qos_fraction: float = 0.3,
                 deadline_slack: Tuple[float, float] = (2.0, 6.0),
                 prefix: str = "S"):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.work_range = tuple(work_range)
        self.mem_range_gb = tuple(mem_range_gb)
        self.qos_fraction = float(qos_fraction)
        self.deadline_slack = tuple(deadline_slack)
        self.prefix = prefix
        self.seed = seed
        self.pool = self._draw_pool(pool_seed, pool_size)
        self._rows: list = []
        self._epoch = 0
        self.jobs: List[JobRecord] = []  # every job drawn so far
        self._last_t = 0.0
        self._next_t: Optional[float] = None
        self._row = None
        self._seq = 0
        self._staged: list = []  # (t, seq, kind, record)

    def _draw_pool(self, pool_seed: int, n: int) -> list:
        """``(gap, work, steady, slack or None)`` a job, drawn in the
        program's order (gap, work, memory, deadline coin, slack)."""
        rng = np.random.default_rng(pool_seed)
        lo, hi = self.work_range
        out = []
        for _ in range(n):
            gap = rng.exponential(1.0 / self.rate)
            work = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            steady = rng.uniform(*self.mem_range_gb) * GB
            slack = (rng.uniform(*self.deadline_slack)
                     if rng.uniform() < self.qos_fraction else None)
            out.append((gap, work, steady, slack))
        return out

    def _next_row(self):
        if not self._rows:
            self._rows = _permuted(self.pool, self.seed + self._epoch)[::-1]
            self._epoch += 1
        return self._rows.pop()

    def _draw(self, ta: float, row) -> None:
        i = len(self.jobs)
        _, work, steady, slack = row
        deadline = None if slack is None else ta + work * slack
        rec = JobRecord(f"{self.prefix}{i:04d}", ta, work, steady, deadline)
        self.jobs.append(rec)
        self._staged.append((ta, self._seq, "arrive", rec))
        self._seq += 1
        if deadline is not None:
            self._staged.append((deadline, self._seq, "deadline", rec))
            self._seq += 1

    def take_until(self, t: float) -> List[Tuple[str, JobRecord, float]]:
        """``(kind, record, time)`` of every event at or before ``t``."""
        while True:
            if self._next_t is None:
                self._row = self._next_row()
                self._next_t = self._last_t + self._row[0]
            if self._next_t > t:
                break
            self._last_t, self._next_t = self._next_t, None
            self._draw(self._last_t, self._row)
        due = sorted(e for e in self._staged if e[0] <= t)
        self._staged = [e for e in self._staged if e[0] > t]
        return [(kind, rec, when) for when, _, kind, rec in due]

