"""Runtime health: heartbeats, straggler detection, elastic slice pool.

On a real cluster each slice's host posts heartbeats; here the executor
posts them after every chunk.  Detection logic is shared either way:

  * missed heartbeats ≥ ``max_missed`` → slice presumed dead → scheduler
    ``drop_slice`` (its commitments re-enter bidding; elastic scale-down).
  * per-slice speed EWMA (observed/declared duration ratio) below
    ``straggler_ratio`` → flagged; the executor can then de-prefer it via
    the window policy or drop/readmit it at reduced speed.

Note the paper-native mitigation also holds: a straggling slice inflates
observed durations, ex-post ε grows for jobs placed there, and calibration
shifts bids away — monitor-based detection is the explicit counterpart.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

import numpy as np

__all__ = ["HealthMonitor", "HealthConfig", "retry_with_backoff"]


def retry_with_backoff(
    fn: Callable[[int], object],
    *,
    retries: int = 3,
    base: float = 0.05,
    factor: float = 2.0,
    max_delay: float = 1.0,
    jitter: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    sleep: Callable[[float], None] = time.sleep,
    retryable: Callable[[BaseException], bool] = lambda e: True,
):
    """Call ``fn(attempt)`` with capped exponential backoff between retries.

    ``fn`` receives the 0-based attempt index (so callers can make
    per-attempt decisions deterministic).  Up to ``retries`` retries are
    made after the first attempt; the delay before retry ``k`` (1-based)
    is ``min(base * factor**(k-1), max_delay)`` plus a deterministic
    jitter term ``U[0, jitter) * delay`` drawn from ``rng`` — with a
    seeded generator the full delay sequence is reproducible, which is
    what lets fault-injection runs replay byte-identically.

    Exceptions for which ``retryable`` returns False propagate
    immediately; the last exception propagates when attempts are
    exhausted.  ``sleep`` is injectable so simulated time never blocks
    on wall-clock waits (the simulator passes a no-op).
    """
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn(attempt)
        except BaseException as exc:  # noqa: BLE001 - filtered by `retryable`
            if not retryable(exc) or attempt == retries:
                raise
            last = exc
            delay = min(base * factor**attempt, max_delay)
            if jitter > 0.0 and rng is not None:
                delay += float(rng.uniform(0.0, jitter)) * delay
            if delay > 0.0:
                sleep(delay)
    raise last  # pragma: no cover - unreachable (loop always returns/raises)


@dataclass(frozen=True)
class HealthConfig:
    heartbeat_interval: float = 5.0
    max_missed: int = 3
    straggler_ratio: float = 0.6  # observed speed below 60% of nominal
    speed_halflife: int = 8


@dataclass
class _SliceHealth:
    last_heartbeat: float = 0.0
    speed_ewma: float = 1.0
    n_obs: int = 0


class HealthMonitor:
    def __init__(self, cfg: HealthConfig = HealthConfig()):
        self.cfg = cfg
        self._slices: Dict[str, _SliceHealth] = {}

    def register(self, slice_id: str, now: Optional[float] = None) -> None:
        self._slices[slice_id] = _SliceHealth(
            last_heartbeat=now if now is not None else time.time())

    def remove(self, slice_id: str) -> None:
        self._slices.pop(slice_id, None)

    def heartbeat(self, slice_id: str, now: Optional[float] = None,
                  observed_speed: Optional[float] = None) -> None:
        st = self._slices.setdefault(slice_id, _SliceHealth())
        st.last_heartbeat = now if now is not None else time.time()
        if observed_speed is not None:
            decay = 0.5 ** (1.0 / self.cfg.speed_halflife)
            st.speed_ewma = decay * st.speed_ewma + (1 - decay) * observed_speed
            st.n_obs += 1

    def dead_slices(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        limit = self.cfg.heartbeat_interval * self.cfg.max_missed
        return [s for s, st in self._slices.items()
                if now - st.last_heartbeat > limit]

    def stragglers(self) -> List[str]:
        return [s for s, st in self._slices.items()
                if st.n_obs >= 2 and st.speed_ewma < self.cfg.straggler_ratio]

    def speed(self, slice_id: str) -> float:
        st = self._slices.get(slice_id)
        return st.speed_ewma if st else 1.0
