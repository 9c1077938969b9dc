"""Wall-clock spans of the port's host paths: the one tracer of ``repro_torch``.

A span is a named stretch of the host's time, with its start and end on
``time.perf_counter_ns()``, the span that was open around it (its parent)
and a few attributes.  The spans of one auction round share the round's
time ``now``; the spans of one served request share its ``request_id``.

    from repro_torch.runtime import trace

    with trace.span("round.pack", now=now) as sp:
        ...
        if sp is not None:
            sp.attrs["bids"] = len(pool)

Tracing is **on** while :func:`enable` holds, or while a ``torch.profiler``
records in the process; **off** otherwise.  Off, :func:`span` makes that
one check and returns a shared no-op context manager (``as`` binds
``None``).  On, each span is kept in a buffer of fixed size (the oldest go
first, counted in :func:`dropped`), and under a recording profiler it is
also opened as ``torch.profiler.record_function(name)``, so a profiler's
trace shows the phases beside the kernels they launched.  While on, each
pause of Python's cyclic collector is kept as a span ``gc`` with its
``generation``.  Read the spans with :func:`spans`; :func:`reset` clears
them.  There is no exporter: a reader takes the spans from memory.

The tracer is single-threaded: the port's main paths are one Python loop.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import time
from typing import Deque, Dict, Iterator, List, Optional

import torch

__all__ = ["Span", "span", "record", "stamp", "enable", "enabled", "spans",
           "reset", "dropped", "CAPACITY"]

#: spans the buffer keeps before the oldest go
CAPACITY = 1 << 16

_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class Span:
    """One finished (or still open) span; times in ``perf_counter_ns``."""

    __slots__ = ("name", "start", "end", "parent", "attrs")

    def __init__(self, name: str, start: int, parent: Optional["Span"],
                 attrs: Dict[str, object]):
        self.name = name
        self.start = start
        self.end: Optional[int] = None
        self.parent = parent
        self.attrs = attrs

    @property
    def duration_ns(self) -> int:
        return self.end - self.start

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start}, {self.end}, "
                f"parent={self.parent.name if self.parent else None!r}, "
                f"{self.attrs!r})")


class _Noop:
    """What :func:`span` returns while tracing is off (one shared object)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()


class _Open:
    """An open span, closed by ``__exit__`` (also when the block raises)."""

    __slots__ = ("span", "range")

    def __init__(self, s: Span, rng):
        self.span = s
        self.range = rng

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.end = _clock()  # before the range closes: the two ends agree
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _pop(s)
        return False


class _State:
    def __init__(self):
        self.enabled = 0  # depth of enable() blocks
        self.buf: Deque[Span] = collections.deque(maxlen=CAPACITY)
        self.dropped = 0
        self.stack: List[Span] = []  # the open spans, innermost last
        self.gc_hooked = False
        self.gc_span: Optional[Span] = None


_state = _State()


def enabled() -> bool:
    """True while spans are recorded."""
    return bool(_state.enabled) or _profiling()


def _open(name: str, attrs: Dict[str, object]) -> Span:
    """Keep a new span, open, as the innermost; the caller sets its start."""
    st = _state
    if not st.gc_hooked:
        gc.callbacks.append(_on_gc)
        st.gc_hooked = True
    s = Span(name, 0, st.stack[-1] if st.stack else None, attrs)
    if len(st.buf) == st.buf.maxlen:
        st.dropped += 1
    st.buf.append(s)
    st.stack.append(s)
    return s


def _pop(s: Span) -> None:
    stack = _state.stack
    if stack and stack[-1] is s:
        stack.pop()
    elif s in stack:  # closed out of order (a generator left open)
        stack.remove(s)


def span(name: str, **attrs):
    """A context manager timing its block as span ``name``."""
    if not (_state.enabled or _profiling()):
        return _NOOP
    rng = torch.profiler.record_function(name) if _profiling() else None
    opened = _Open(_open(name, attrs), rng)
    # allocate first, then read the clock right before the range starts: a
    # collection that an allocation sets off falls before both
    opened.span.start = _clock()
    if rng is not None:
        rng.__enter__()
    return opened


def stamp() -> Optional[int]:
    """The clock now while tracing is on (a start for :func:`record`),
    else None."""
    if not (_state.enabled or _profiling()):
        return None
    return _clock()


def record(name: str, start: Optional[int], **attrs) -> None:
    """Keep a span ``name`` from ``start`` (a :func:`stamp`) to now: for a
    stretch that no one block holds, such as a request's wait in a queue.
    Nothing is kept while tracing is off or without a start."""
    if start is None or not (_state.enabled or _profiling()):
        return
    s = _open(name, attrs)
    s.start, s.end = start, _clock()
    _pop(s)


def _on_gc(phase: str, info: dict) -> None:
    st = _state
    if phase == "start":
        if not (st.enabled or _profiling()):
            _unhook()  # tracing went off with the profiler
            return
        st.gc_span = _open("gc", {"generation": info["generation"]})
        st.gc_span.start = _clock()
    elif st.gc_span is not None:
        st.gc_span.end = _clock()
        _pop(st.gc_span)
        st.gc_span = None


def _unhook() -> None:
    st = _state
    if st.gc_hooked:
        st.gc_hooked = False
        st.gc_span = None
        # the hook is appended last, so removing it while the collector
        # calls its callbacks skips none of the others
        gc.callbacks.remove(_on_gc)


@contextlib.contextmanager
def enable() -> Iterator[None]:
    """Record spans inside the block (blocks may nest)."""
    st = _state
    st.enabled += 1
    if not st.gc_hooked:
        gc.callbacks.append(_on_gc)
        st.gc_hooked = True
    try:
        yield
    finally:
        st.enabled -= 1
        if not st.enabled and not _profiling():
            _unhook()


def spans(name: Optional[str] = None) -> List[Span]:
    """The kept spans that have ended (of ``name`` alone, if given), in
    the order they started."""
    return [s for s in _state.buf
            if s.end is not None and (name is None or s.name == name)]


def dropped() -> int:
    """Spans the full buffer let go since the last :func:`reset`."""
    return _state.dropped


def reset() -> None:
    """Forget every kept span."""
    _state.buf.clear()
    _state.dropped = 0
