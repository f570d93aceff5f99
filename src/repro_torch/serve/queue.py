"""Admission queue: requests in, planner-sized waves out.

The planner sizes one dispatch batch -- ``E`` elements -- to fill the
target's HBM pseudo-channels; callers arrive with whatever element
count their problem has.  The queue coalesces submitted requests, in
FIFO order, into *waves* of exactly ``E`` elements: a large request
spans several waves, several small requests share one, and an
undersized final wave is zero-padded (the pad is accounted, never
silent -- the same ``batch_pad_elements`` discipline the planner applies
when it snaps ``E`` to a block size).

A wave is only formed when ``E`` elements are pending, except when the
max-latency knob (``max_wait_s``) says the oldest request has waited
long enough, or the caller forces a flush (drain/shutdown) -- then a
padded partial wave goes out.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ServeRequest:
    """One submitted request: per-element input rows in, output rows out.

    ``inputs`` maps the chain's qualified host stream names
    (``"stage.input"``) to arrays with a leading element axis of
    ``n_elements`` rows.  ``outputs`` fills in as the request's waves
    retire; ``error`` is set instead when any of its waves failed or the
    engine shut down with the request in flight.
    """

    rid: int
    inputs: Dict[str, np.ndarray]
    n_elements: int
    submitted_s: float = 0.0
    #: when the request's first slice was fed to the ring -- the
    #: queue-wait / wave-execution boundary of the latency decomposition
    admitted_s: float = 0.0
    completed_s: float = 0.0
    #: execution time attributable to wave zero-padding: each of the
    #: request's waves charges pad/E of its wall time here
    pad_overhead_s: float = 0.0
    outputs: Optional[Dict[str, np.ndarray]] = None
    error: Optional[BaseException] = None
    #: wave-slices this request was split into / already retired
    parts: int = 0
    parts_done: int = 0

    @property
    def done(self) -> bool:
        """Finished -- successfully (``outputs``) or not (``error``)."""
        return self.error is not None or (
            self.parts > 0 and self.parts_done >= self.parts
        )


@dataclasses.dataclass(frozen=True)
class WavePart:
    """One request's element slice ``[lo:hi)`` placed at ``dst`` in the
    wave's E-sized batch."""

    request: ServeRequest
    lo: int
    hi: int
    dst: int

    @property
    def n(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass(frozen=True)
class Wave:
    """One coalesced admission: parts covering ``E - pad_elements``
    rows, the rest zero-padding."""

    parts: tuple
    pad_elements: int


class AdmissionQueue:
    """FIFO element coalescer over :class:`ServeRequest`.

    ``clock`` is injectable for tests (defaults to ``time.monotonic``).
    ``metrics`` (a ``repro_torch.metrics`` registry; None/NULL = off) records
    queue-depth gauges, wave size/fill-ratio/wait-age histograms, and a
    per-reason flush counter -- every wave is credited to exactly one of
    ``full`` (E pending), ``max_wait`` (latency knob expired), or
    ``force`` (drain/shutdown).
    """

    def __init__(self, batch_elements: int, *,
                 max_wait_s: Optional[float] = None,
                 clock=time.monotonic, metrics=None) -> None:
        if batch_elements < 1:
            raise ValueError(
                f"batch_elements must be >= 1, got {batch_elements}"
            )
        self.batch_elements = batch_elements
        self.max_wait_s = max_wait_s
        self.clock = clock
        #: (request, next element offset) cursors, FIFO
        self._q: deque = deque()
        self._m = None
        if metrics:
            from ..metrics import linear_buckets

            E = batch_elements
            self._m = {
                "depth_requests": metrics.gauge(
                    "admission_queue_depth_requests",
                    "Requests with unadmitted elements still queued."),
                "depth_elements": metrics.gauge(
                    "admission_queue_depth_elements",
                    "Element rows pending admission."),
                "wave_size": metrics.histogram(
                    "admission_wave_size_elements",
                    "Real (non-pad) element rows per admitted wave.",
                    buckets=linear_buckets(0, E, min(E, 16))),
                "fill": metrics.histogram(
                    "admission_wave_fill_ratio",
                    "Wave fill: real rows / E (1.0 = no padding).",
                    buckets=linear_buckets(0.0, 1.0, 10)),
                "wait": metrics.histogram(
                    "admission_wait_age_seconds",
                    "Age of the oldest queued request at wave admission."),
                "flush": {
                    reason: metrics.counter(
                        "admission_flush_total",
                        "Admitted waves by trigger: full E pending, "
                        "max_wait_s expiry, or forced (drain/shutdown).",
                        reason=reason)
                    for reason in ("full", "max_wait", "force")
                },
            }

    def _gauge_depth(self) -> None:
        if self._m is not None:
            self._m["depth_requests"].set(float(len(self._q)))
            self._m["depth_elements"].set(float(self.pending_elements))

    def push(self, req: ServeRequest) -> None:
        req.submitted_s = self.clock()
        self._q.append([req, 0])
        self._gauge_depth()

    def remove(self, req: ServeRequest) -> bool:
        """Drop a request that has not been (partially) admitted yet --
        the reject path.  Returns False if admission already began."""
        for entry in self._q:
            if entry[0] is req:
                if entry[1] != 0:
                    return False
                self._q.remove(entry)
                self._gauge_depth()
                return True
        return False

    @property
    def pending_elements(self) -> int:
        return sum(r.n_elements - off for r, off in self._q)

    @property
    def pending_requests(self) -> List[ServeRequest]:
        return [r for r, _ in self._q]

    def ready(self, *, force: bool = False) -> bool:
        """Is a wave due?  A full ``E`` is pending, or the oldest
        request has outwaited ``max_wait_s``, or the caller forces."""
        if not self._q:
            return False
        if self.pending_elements >= self.batch_elements:
            return True
        if force:
            return True
        if self.max_wait_s is not None:
            return self.clock() - self._q[0][0].submitted_s >= self.max_wait_s
        return False

    def pop_wave(self, *, force: bool = False) -> Optional[Wave]:
        """Assemble the next wave, or None when none is due.

        Requests are consumed strictly FIFO; a request larger than the
        remaining room contributes a slice and keeps its place at the
        head for the next wave.
        """
        if not self.ready(force=force):
            return None
        E = self.batch_elements
        reason, age = "force", 0.0
        if self._m is not None:
            age = self.clock() - self._q[0][0].submitted_s
            if self.pending_elements >= E:
                reason = "full"
            elif (self.max_wait_s is not None
                  and age >= self.max_wait_s):
                reason = "max_wait"
        parts: List[WavePart] = []
        dst = 0
        while self._q and dst < E:
            req, off = self._q[0]
            take = min(req.n_elements - off, E - dst)
            parts.append(WavePart(req, off, off + take, dst))
            req.parts += 1
            dst += take
            if off + take >= req.n_elements:
                self._q.popleft()
            else:
                self._q[0][1] = off + take
        if self._m is not None:
            self._m["wave_size"].observe(float(dst))
            self._m["fill"].observe(dst / E)
            self._m["wait"].observe(age)
            self._m["flush"][reason].inc()
            self._gauge_depth()
        return Wave(parts=tuple(parts), pad_elements=E - dst)
