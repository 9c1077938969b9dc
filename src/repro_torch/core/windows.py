"""Window derivation and announcement (paper §3.1, §5.1(c)) — round model.

The scheduler maintains a per-slice time–capacity map (committed execution
intervals) and derives contiguous idle gaps.  One **auction round** announces
ALL eligible gaps across all slices at once (:func:`announce_windows`); the
``WindowPolicy`` kinds are *orderings* over that set rather than single
picks:

* ``earliest``   — earliest start time first (the paper prototype's default,
                   "minimizing latency between announcement and generation").
* ``largest``    — largest gap first (fragmentation-averse).
* ``best_fit``   — smallest gap that still admits τ_min work first (packs
                   tight gaps before they expire).
* ``slack``      — gaps on the idlest slice in the horizon first.
* ``frag_aware`` — tightest capacity fit against the pending pool's
                   capacity-demand histogram first (anti-fragmentation:
                   big windows are not nibbled by jobs a small window
                   could serve).  The demand histogram is supplied by the
                   repartition layer (``core/repartition.py``); with no
                   demand attached the ordering degrades to
                   capacity-ascending (smallest slices first).

:func:`announce_window` (the legacy single-window API, paper A3: one w* per
iteration) is kept as the head of the same ordering and backs the
scheduler's ``step()`` compatibility wrapper.

Window announcement respects a preparation offset (§5.1(a) mitigation (i)):
announced windows start at least ``announce_offset`` after "now" so jobs have
time to generate variants.

Announced-but-unfilled windows are suppressed for a cooldown via
:class:`DeadWindowRegistry`, which matches window starts with an epsilon
tolerance — releases and early finishes perturb gap boundaries by float
drift, and an exact (slice_id, t_min) key would resurrect a dead window the
moment its start moved by 1e-12.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from .types import DEAD_WINDOW_EPS, SliceSpec, Window

__all__ = [
    "SliceTimeline",
    "WindowPolicy",
    "DeadWindowRegistry",
    "announce_window",
    "announce_windows",
]


class SliceTimeline:
    """Committed busy intervals on one slice, kept sorted and merged."""

    def __init__(self, spec: SliceSpec):
        self.spec = spec
        # disjoint, sorted busy intervals [(start, end)]
        self._busy: List[Tuple[float, float]] = []

    # -- mutation -----------------------------------------------------------
    def commit(self, start: float, end: float) -> None:
        if end <= start:
            raise ValueError("empty commitment")
        i = bisect.bisect_left(self._busy, (start, end))
        # check neighbours for overlap (commitments must be conflict-free)
        for j in (i - 1, i):
            if 0 <= j < len(self._busy):
                s, e = self._busy[j]
                if start < e - 1e-12 and s < end - 1e-12:
                    raise ValueError(
                        f"overlapping commitment [{start},{end}) on {self.spec.slice_id}"
                    )
        self._busy.insert(i, (start, end))
        self._merge()

    def release(self, start: float, end: float) -> None:
        """Carve [start, end) out of the busy set (failure / early finish).

        Implemented as interval subtraction: adjacent commitments may have
        been merged, so exact-match removal would be incorrect.
        """
        out: List[Tuple[float, float]] = []
        for s, e in self._busy:
            if e <= start + 1e-12 or s >= end - 1e-12:
                out.append((s, e))
                continue
            if s < start - 1e-12:
                out.append((s, start))
            if e > end + 1e-12:
                out.append((end, e))
        self._busy = out

    def _merge(self) -> None:
        merged: List[Tuple[float, float]] = []
        for s, e in self._busy:
            if merged and s <= merged[-1][1] + 1e-12:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self._busy = merged

    # -- queries --------------------------------------------------------------
    def busy(self) -> Sequence[Tuple[float, float]]:
        return tuple(self._busy)

    def gaps(self, t_from: float, horizon: float) -> List[Tuple[float, float]]:
        """Idle [start, end) intervals within [t_from, t_from + horizon)."""
        t_end = t_from + horizon
        out: List[Tuple[float, float]] = []
        cur = t_from
        for s, e in self._busy:
            if e <= t_from:
                continue
            if s >= t_end:
                break
            if s > cur:
                out.append((cur, min(s, t_end)))
            cur = max(cur, e)
        if cur < t_end:
            out.append((cur, t_end))
        return [(s, e) for s, e in out if e - s > 1e-12]

    def idle_fraction(self, t_from: float, horizon: float) -> float:
        idle = sum(e - s for s, e in self.gaps(t_from, horizon))
        return idle / horizon if horizon > 0 else 0.0

    def busy_until(self, t: float) -> float:
        """End of the interval covering t (t itself if idle)."""
        for s, e in self._busy:
            if s <= t < e:
                return e
        return t


@dataclass(frozen=True)
class WindowPolicy:
    kind: str = "earliest"  # earliest | largest | best_fit | slack | frag_aware
    horizon: float = 1000.0  # lookahead for gap derivation
    announce_offset: float = 0.0  # §5.1(a)(i): bid-preparation time offset
    min_gap: float = 1.0  # don't announce gaps shorter than this (≈ τ_min)


class DeadWindowRegistry:
    """Announced-but-unfilled windows suppressed until a cooldown expires.

    Matching is epsilon-tolerant on the window start: a gap whose boundary
    drifted by float noise (release / early finish / re-merge) is still the
    same dead window.

    Invariants the round pipeline (core/pipeline.py) relies on:

    * settling a round only ever ADDS suppressions (``add``) — it never
      resurrects a window — so a speculative announcement can be validated
      by re-checking ``suppressed`` per window and *filtering*, without
      re-deriving gaps;
    * ``prune`` is deterministic in ``(registry state, now)`` and
      idempotent at a fixed ``now``, so speculative preparation may prune
      early for the next round's timestamp without changing what a serial
      preparation at that timestamp would see.
    """

    def __init__(self, eps: float = DEAD_WINDOW_EPS):
        self.eps = eps
        # slice_id -> [(t_min, expiry)]
        self._entries: Dict[str, List[Tuple[float, float]]] = {}

    def add(self, slice_id: str, t_min: float, expiry: float) -> None:
        entries = self._entries.setdefault(slice_id, [])
        for i, (t, _) in enumerate(entries):
            if abs(t - t_min) <= self.eps:
                entries[i] = (t, max(entries[i][1], expiry))
                return
        entries.append((t_min, expiry))

    def prune(self, now: float) -> None:
        for sid in list(self._entries):
            kept = [(t, e) for t, e in self._entries[sid] if e > now]
            if kept:
                self._entries[sid] = kept
            else:
                del self._entries[sid]

    def suppressed(self, slice_id: str, t_min: float) -> bool:
        return any(
            abs(t - t_min) <= self.eps for t, _ in self._entries.get(slice_id, ())
        )

    def drop_slice(self, slice_id: str) -> int:
        """Retire every entry for a slice that permanently left the pool.

        ``prune`` only shrinks entries by expiry, so repeated slice
        birth/death (repartition split/merge cycles reuse canonical slice
        ids) would otherwise accumulate suppressions that wrongly mute a
        NEW slice born under the same id.  Returns the number of entries
        dropped.
        """
        return len(self._entries.pop(slice_id, ()))

    def __len__(self) -> int:
        return sum(len(v) for v in self._entries.values())

    def clear(self) -> None:
        self._entries.clear()


ExcludeLike = Union[None, DeadWindowRegistry, Set[Tuple[str, float]]]


def _is_excluded(exclude: ExcludeLike, slice_id: str, t_min: float) -> bool:
    if exclude is None:
        return False
    if isinstance(exclude, DeadWindowRegistry):
        return exclude.suppressed(slice_id, t_min)
    # legacy float-keyed set (kept for external callers)
    return (slice_id, round(t_min, 9)) in exclude


def _tight_fit(capacity: float, demand: Optional[Sequence[float]]) -> float:
    """Slack between a slice's capacity and the tightest pending demand it
    can serve (``capacity`` itself when no demand fits: such a slice is
    smaller than every floor, so announcing it early risks stranding
    nothing — it competes on raw capacity against the fit slacks)."""
    if demand:
        fits = [capacity - d for d in demand if d <= capacity]
        if fits:
            return min(fits)
    return capacity


def announce_windows(
    slices: Dict[str, SliceTimeline],
    now: float,
    policy: WindowPolicy,
    *,
    exclude: ExcludeLike = None,
    demand: Optional[Sequence[float]] = None,
) -> List[Window]:
    """All eligible windows for this round, ordered by the policy key.

    Every idle gap of at least ``min_gap`` across every slice within the
    horizon becomes a window; the ``policy.kind`` determines the *order* the
    windows are presented in (ties broken by start time, then slice id, so
    the ordering is deterministic across runs).

    ``demand`` is the pending pool's capacity-demand histogram (a sequence
    of ``min_capacity`` requirements in bytes) and only affects the
    ``frag_aware`` ordering; all other kinds ignore it, so their keys are
    unchanged by its presence.
    """
    t0 = now + policy.announce_offset
    candidates: List[Tuple[tuple, Window]] = []  # (policy key, window)
    for sid in sorted(slices):
        tl = slices[sid]
        idle = None  # lazily computed once per slice for the "slack" kind
        fit = None  # lazily computed once per slice for "frag_aware"
        for s, e in tl.gaps(t0, policy.horizon):
            if e - s < policy.min_gap:
                continue
            if _is_excluded(exclude, sid, s):
                continue
            if policy.kind == "earliest":
                key = (s, -(e - s), sid)
            elif policy.kind == "largest":
                key = (-(e - s), s, sid)
            elif policy.kind == "best_fit":
                key = (e - s, s, sid)
            elif policy.kind == "slack":
                if idle is None:
                    idle = tl.idle_fraction(t0, policy.horizon)
                key = (-idle, s, sid)
            elif policy.kind == "frag_aware":
                if fit is None:
                    fit = _tight_fit(tl.spec.capacity_bytes, demand)
                key = (fit, s, -(e - s), sid)
            else:
                raise ValueError(f"unknown window policy {policy.kind}")
            w = Window(slice_id=sid, capacity=tl.spec.capacity_bytes, t_min=s, duration=e - s)
            candidates.append((key, w))
    candidates.sort(key=lambda c: c[0])
    return [w for _, w in candidates]


def announce_window(
    slices: Dict[str, SliceTimeline],
    now: float,
    policy: WindowPolicy,
    *,
    exclude: ExcludeLike = None,
    demand: Optional[Sequence[float]] = None,
) -> Optional[Window]:
    """Pick ONE window (legacy A3 semantics): head of the round ordering.

    Returns None when no gap of at least ``min_gap`` exists in the horizon.
    """
    ws = announce_windows(slices, now, policy, exclude=exclude, demand=demand)
    return ws[0] if ws else None
