"""Admission control: back-pressure before the bid pool outgrows a bucket.

Scoring dispatch pads pooled bids to pow2 M-buckets
(``kernels.jasda_score.ops.bucket_m``), so the natural back-pressure
point is the largest bucket the deployment budgets one executable for:
once the queued (never-awarded) jobs would push the pooled bid rows past
``max_bucket_m``, admitting more jobs only grows per-round latency
without growing throughput.  :func:`queue_bound_for_bucket` converts
that bucket budget into a queue-depth bound using a conservative
rows-per-job estimate (chunk-chain alternatives × announced windows).

Three policies, all deterministic given the arrival stream:

* :class:`AcceptAll` — the open-loop control; queue grows unboundedly
  under overload (the degradation the benchmark demonstrates).
* :class:`BoundedQueue` — cap on queued jobs with shed-lowest-score:
  when full, the lowest-priority candidate among {queue ∪ new arrival}
  is shed.  Priority is work-normalized (`spec.priority` per unit of
  remaining work — an SRPT-flavored rule: small jobs are retained
  preferentially because they convert queue slots into completions,
  which is exactly what the goodput SLO measures).
* :class:`TokenBucket` — a classic rate limiter on admissions; sheds
  new arrivals only, never queued jobs.

Shed jobs are notified through the ``LOSS_SHED`` out-of-round feedback
(``negotiation.messages.build_shed_feedback`` / ``scheduler.shed_job``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = [
    "AdmissionPolicy",
    "AcceptAll",
    "BoundedQueue",
    "TokenBucket",
    "queue_bound_for_bucket",
]

#: conservative pooled-rows-per-queued-job estimate: ~2 chunk-chain
#: alternatives × ~8 announced windows a queued job typically bids on
ROWS_PER_JOB_ESTIMATE = 16


def queue_bound_for_bucket(max_bucket_m: int,
                           rows_per_job: int = ROWS_PER_JOB_ESTIMATE) -> int:
    """Queue depth that keeps pooled bid rows within one pow2 bucket."""
    return max(4, int(max_bucket_m) // max(1, int(rows_per_job)))


class AdmissionPolicy:
    """Protocol: decide one arrival's fate given the current bid pool.

    ``queue`` holds ALL live (unfinished) agents — the bid pool whose
    pooled rows the scoring bucket must hold; every member bids each
    round, so this is the set back-pressure bounds.  Returns
    ``(admit_new, to_shed)``: whether the arriving agent enters, plus
    pool members to evict to make room.  Policies are plain picklable
    objects; any internal state (token level) rides the service
    checkpoint.
    """

    name = "base"

    def on_arrival(self, agent, now: float,
                   queue: Sequence) -> Tuple[bool, List]:
        raise NotImplementedError


class AcceptAll(AdmissionPolicy):
    """No back-pressure: every arrival is admitted (the control)."""

    name = "accept_all"

    def on_arrival(self, agent, now: float,
                   queue: Sequence) -> Tuple[bool, List]:
        return True, []


def _priority(agent) -> float:
    """Shed score: declared priority per unit of remaining work (SRPT-ish).

    Higher keeps the slot.  Remaining work uses the agent's live biddable
    pool, so a queued job that somehow made progress is worth more than
    its static spec suggests.
    """
    remaining = max(float(agent.biddable_work), 1e-9)
    return float(agent.spec.priority) / remaining


class BoundedQueue(AdmissionPolicy):
    """Cap the live bid pool at ``max_queue``; shed the lowest-priority job.

    ``max_queue=None`` lets the service engine resolve the bound from its
    configured pow2 bucket budget (``queue_bound_for_bucket``).  When the
    pool is full the arrival competes with its members on
    :func:`_priority` (SRPT-flavored: priority per unit of REMAINING
    work, so nearly-done jobs are effectively unevictable and big fresh
    jobs shed first): if some pool member scores lower it is evicted and
    the arrival admitted, otherwise the arrival itself is shed.  Ties
    break toward keeping the incumbent (stable under replay).
    """

    name = "bounded_queue"

    def __init__(self, max_queue: int = None):
        self.max_queue = max_queue

    def on_arrival(self, agent, now: float,
                   queue: Sequence) -> Tuple[bool, List]:
        bound = self.max_queue if self.max_queue is not None else 64
        if len(queue) < bound:
            return True, []
        new_p = _priority(agent)
        victim = min(queue, key=_priority)
        if _priority(victim) < new_p:
            return True, [victim]
        return False, []


class TokenBucket(AdmissionPolicy):
    """Admission rate limiter: ``rate`` tokens/unit time, ``burst`` cap.

    Deterministic in the arrival timestamps (no clock reads); refill is
    computed lazily from the inter-arrival gap.  Sheds new arrivals only.
    """

    name = "token_bucket"

    def __init__(self, rate: float, burst: float = 8.0):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = 0.0

    def on_arrival(self, agent, now: float,
                   queue: Sequence) -> Tuple[bool, List]:
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True, []
        return False, []
