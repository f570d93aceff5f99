"""Span/counter tracer: the low-overhead event recorder the whole
execution stack threads through.

The executor is judged by how close it gets to the plan's roofline, so
the recorder mirrors the planner's vocabulary: nested **spans** (chain
run -> stage -> batch-slot dispatch/compute/handoff) carry explicit
begin/end timestamps from an injectable clock, and monotone **counters**
(bytes per pseudo-channel, pad elements, CU-group occupancy) accumulate
the deterministic quantities the plan predicts -- so a trace can be
diffed against a :class:`~repro_torch.memory.chain.ChainPlan` term by term
(``repro_torch.trace.attribution``).

Spans live on integer *tracks* (one per pipeline stage plus track 0 for
the host side); within a track they must nest strictly -- :meth:`end`
enforces LIFO order, so a malformed instrumentation site fails loudly at
record time instead of producing an unreadable trace.

When tracing is off, callers hold the module-level :data:`NULL`
:class:`NullTracer` (or plain ``None``): it is falsy, so the hot loops
guard every instrumentation site with ``if tracer:`` and a disabled run
pays one truthiness check per site -- no allocation, no clock read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

#: Host-side track: staging, retire syncs, and the root run span.
HOST_TRACK = 0


@dataclasses.dataclass
class SpanEvent:
    """One closed (or still-open) span.  ``t1 < 0`` means still open."""

    name: str
    cat: str
    track: int
    t0: float
    t1: float = -1.0
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return max(0.0, self.t1 - self.t0) if self.t1 >= 0 else 0.0

    @property
    def open(self) -> bool:
        return self.t1 < 0


@dataclasses.dataclass(frozen=True)
class CounterEvent:
    """One counter sample: the *cumulative* series values at ``t``."""

    name: str
    track: int
    t: float
    values: Dict[str, float]


class TraceError(RuntimeError):
    """Malformed instrumentation: spans ended out of order / never begun."""


class NullTracer:
    """The disabled tracer: falsy, every method a no-op.

    Executors write ``if tracer: tracer.begin(...)`` so a disabled run
    never allocates an event or reads the clock; passing :data:`NULL`
    (or ``None``) is equivalent everywhere.
    """

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def name_track(self, track: int, name: str) -> None:
        pass

    def begin(self, name: str, cat: str = "", track: int = 0,
              **args: Any) -> None:
        return None

    def end(self, span: Any = None) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", track: int = 0,
             **args: Any) -> Iterator[None]:
        yield None

    def bump(self, name: str, values: Dict[str, float],
             track: int = 0) -> None:
        pass

    def totals(self, name: str) -> Dict[str, float]:
        return {}


#: Shared disabled-tracer instance (``tracer or NULL`` normalizes None).
NULL = NullTracer()


class Tracer:
    """Records nested spans and cumulative counters with explicit
    timestamps from ``clock`` (injectable so tests are deterministic).

    One tracer records one run; it is not thread-safe -- the executors it
    instruments are single-threaded host loops.  A CUDA launch returns
    once the kernel is queued, so on the card the pipeline driver gives
    each stage's slot and dispatch spans the device's own times (a CUDA
    event pair, read when the batch retires) and keeps the host-clock
    duration as the ``host_s`` arg; host-track spans (staging, syncs,
    the root run span) stay on the host clock.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.spans: List[SpanEvent] = []
        self.counters: List[CounterEvent] = []
        self.track_names: Dict[int, str] = {}
        self.meta: Dict[str, Any] = {}
        self._stacks: Dict[int, List[SpanEvent]] = {}
        self._totals: Dict[str, Dict[str, float]] = {}

    def __bool__(self) -> bool:
        return True

    # -- spans --------------------------------------------------------------
    def name_track(self, track: int, name: str) -> None:
        """Label a track (rendered as the thread name in Perfetto)."""
        self.track_names[track] = name

    def begin(self, name: str, cat: str = "", track: int = 0,
              **args: Any) -> SpanEvent:
        sp = SpanEvent(name=name, cat=cat, track=track, t0=self.clock(),
                       args=dict(args))
        self.spans.append(sp)
        self._stacks.setdefault(track, []).append(sp)
        return sp

    def end(self, span: SpanEvent) -> None:
        """Close ``span``; must be the innermost open span of its track
        (strict nesting is enforced at record time)."""
        stack = self._stacks.get(span.track, [])
        if not stack or stack[-1] is not span:
            raise TraceError(
                f"span {span.name!r} ended out of order on track "
                f"{span.track} (open: {[s.name for s in stack]})"
            )
        stack.pop()
        span.t1 = self.clock()

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", track: int = 0,
             **args: Any) -> Iterator[SpanEvent]:
        sp = self.begin(name, cat, track, **args)
        try:
            yield sp
        finally:
            self.end(sp)

    def open_spans(self) -> List[SpanEvent]:
        return [s for st in self._stacks.values() for s in st]

    # -- counters -----------------------------------------------------------
    def bump(self, name: str, values: Dict[str, float],
             track: int = 0) -> None:
        """Add ``values`` to the counter's running totals and record a
        cumulative sample (monotone counters render as rate tracks in
        Perfetto; :meth:`totals` gives the end-of-run sums)."""
        tot = self._totals.setdefault(name, {})
        for k, v in values.items():
            tot[str(k)] = tot.get(str(k), 0) + v
        self.counters.append(
            CounterEvent(name=name, track=track, t=self.clock(),
                         values=dict(tot))
        )

    def totals(self, name: str) -> Dict[str, float]:
        """End-of-run cumulative totals for one counter series."""
        return dict(self._totals.get(name, {}))

    # -- queries ------------------------------------------------------------
    def spans_by(self, *, cat: Optional[str] = None,
                 track: Optional[int] = None) -> List[SpanEvent]:
        return [
            s for s in self.spans
            if (cat is None or s.cat == cat)
            and (track is None or s.track == track)
        ]

    @property
    def t_start(self) -> float:
        ts = [s.t0 for s in self.spans] + [c.t for c in self.counters]
        return min(ts) if ts else 0.0

    @property
    def t_end(self) -> float:
        ts = [s.t1 for s in self.spans if s.t1 >= 0]
        ts += [c.t for c in self.counters]
        return max(ts) if ts else 0.0
