"""Step-time monitoring: straggler detection + elastic re-mesh hooks.

At pod scale, a slow host (thermal throttling, failing NIC) shows up as a
step-time outlier on every worker because SPMD steps are synchronous.  The
monitor keeps an EWMA of step time and flags steps slower than
``straggler_factor`` x EWMA; the runtime's ``on_straggler`` hook can then
evict the host / trigger elastic re-meshing (``plan_elastic_remesh``).

:class:`RequestLatency` is the serving-side sibling: per-request
submit-to-complete latency, summarized over a bounded recent window so a
long-lived ``repro_torch.serve`` engine can report p50/p95 without unbounded
history.  Both delegate their distribution bookkeeping to
:class:`repro_torch.metrics.Histogram` -- one quantile implementation in the
codebase, shared with the always-on metrics layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..metrics import Histogram


@dataclasses.dataclass
class StepMonitor:
    straggler_factor: float = 3.0
    alpha: float = 0.1            # EWMA weight
    warmup: int = 3               # ignore compile-dominated first steps
    #: EWMA weight on *flagged* steps: damped so one outlier cannot poison
    #: the mean, but nonzero so a persistent slowdown eventually moves the
    #: baseline instead of flagging every step forever.
    flagged_alpha: float = 0.02

    def __post_init__(self) -> None:
        self.ewma: Optional[float] = None
        self.count = 0
        self.flags: List[int] = []
        #: every recorded step time (warmup included) -- the flag-stat
        #: summary and any external scrape read quantiles off this
        self.steps = Histogram(name="step_seconds")

    def record(self, dt: float) -> bool:
        self.count += 1
        self.steps.observe(dt)
        if self.count <= self.warmup:
            return False
        if self.ewma is None:
            self.ewma = dt
            return False
        flagged = dt > self.straggler_factor * self.ewma
        w = self.flagged_alpha if flagged else self.alpha
        self.ewma = (1 - w) * self.ewma + w * dt
        if flagged:
            self.flags.append(self.count)
        return flagged

    def summary(self) -> Dict[str, float]:
        """Step-time distribution plus flag stats, histogram-backed."""
        s = self.steps.summary()
        return {
            "count": float(self.count),
            "mean_s": s.get("mean", 0.0),
            "p50_s": s.get("p50", 0.0),
            "p95_s": s.get("p95", 0.0),
            "max_s": s.get("max", 0.0),
            "flagged": float(len(self.flags)),
            "flag_rate": len(self.flags) / self.count if self.count else 0.0,
        }


@dataclasses.dataclass
class RequestLatency:
    """Submit-to-complete latency tracker for the serving engine.

    Exact count/mean/max over the whole run; percentiles over the most
    recent ``window`` requests (a serving engine outlives any full-
    history quantile structure worth carrying here).  A thin facade over
    :class:`repro_torch.metrics.Histogram` -- same counts, same window, same
    nearest-rank quantile -- kept for its serving-flavored ``summary()``
    keys and so callers need no registry.
    """

    window: int = 1024

    def __post_init__(self) -> None:
        self._hist = Histogram(
            name="request_latency_seconds", window=self.window
        )

    def record(self, latency_s: float) -> None:
        self._hist.observe(latency_s)

    @property
    def count(self) -> int:
        return self._hist.count

    @property
    def total_s(self) -> float:
        return self._hist.sum

    @property
    def max_s(self) -> float:
        return self._hist.max if self._hist.count else 0.0

    def quantile(self, q: float) -> float:
        """q-quantile (nearest-rank) over the recent window; 0 if empty."""
        return self._hist.quantile(q)

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "mean_s": self.total_s / self.count if self.count else 0.0,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "max_s": self.max_s,
        }


def plan_elastic_remesh(
    n_healthy: int, *, model_axis: int
) -> Tuple[int, ...]:
    """Given the surviving device count, pick the largest (data, model)
    mesh that preserves the TP degree (params reshard along data only --
    cheapest recovery path).  Returns the new mesh shape.

    E.g. 256 devices, model=16 -> (16, 16); after losing a host of 8:
    248 -> (15, 16) needs 240; we round data down.
    """
    if n_healthy < model_axis:
        raise ValueError("fewer devices than the TP degree: cold restart")
    data = n_healthy // model_axis
    return (data, model_axis)


def rebalance_batch(global_batch: int, data_axis: int) -> int:
    """Largest per-step batch divisible by the new data axis (keeps the
    optimizer's effective batch as close as possible after re-meshing)."""
    return (global_batch // data_axis) * data_axis
