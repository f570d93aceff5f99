"""SLO tracking: latency + error-rate targets with windowed burn rates.

An SLO here is two targets -- a p95 latency bound and an error-rate
budget -- and the tracker answers one question continuously: *how fast
is recent traffic burning the budget?*  Following the standard burn-rate
formulation, each target implies an allowance (5% of requests may
exceed a p95 target; ``target_error_rate`` of requests may fail) and
the burn rate is the windowed violation rate over that allowance:
1.0 means budget is being consumed exactly as provisioned, above it the
SLO breaches if the window's behaviour persists.

``verdict()`` folds both burns into ``ok`` / ``warn`` / ``breach``.
When a registry is supplied the tracker also exports its state as
gauges (``slo_latency_burn``, ``slo_error_burn``, ``slo_verdict``) so a
snapshot carries the verdict without a side channel.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Any, Dict, Optional

from .registry import Histogram, MetricsError

#: verdict ordering for the exported gauge (and severity comparisons)
VERDICTS = ("ok", "warn", "breach")


class SLOTracker:
    """Track one serving SLO: p95 latency target + error-rate budget.

    ``window`` bounds the burn-rate computation to recent requests (a
    long-lived engine answers "are we breaching *now*", not "did we ever
    breach").  ``warn_ratio`` is the burn fraction that turns the
    verdict to ``warn``; ``min_count`` withholds judgement until the
    window has evidence.  Latency observations flow through a standard
    :class:`~repro_torch.metrics.registry.Histogram`, so the p95 reported in
    the verdict is the same quantile implementation the rest of the
    codebase uses.
    """

    def __init__(self, target_p95_s: float, target_error_rate: float = 0.01,
                 *, window: int = 256, warn_ratio: float = 0.5,
                 min_count: int = 8, registry=None) -> None:
        if target_p95_s <= 0:
            raise MetricsError(
                f"target_p95_s must be > 0, got {target_p95_s}"
            )
        if not 0.0 <= target_error_rate < 1.0:
            raise MetricsError(
                f"target_error_rate must be in [0, 1), got {target_error_rate}"
            )
        self.target_p95_s = target_p95_s
        self.target_error_rate = target_error_rate
        self.warn_ratio = warn_ratio
        self.min_count = min_count
        self.latency = Histogram(
            name="slo_latency_seconds", window=max(window, 1024)
        )
        self._win: deque = deque(maxlen=window)  # (error, over_target)
        self.errors = 0
        self._g_latency_burn = self._g_error_burn = self._g_verdict = None
        if registry:
            self._g_latency_burn = registry.gauge(
                "slo_latency_burn",
                "Windowed latency-budget burn rate (>= 1.0 breaches).")
            self._g_error_burn = registry.gauge(
                "slo_error_burn",
                "Windowed error-budget burn rate (>= 1.0 breaches).")
            self._g_verdict = registry.gauge(
                "slo_verdict", "0 = ok, 1 = warn, 2 = breach.")
            registry.gauge(
                "slo_target_p95_seconds", "Configured p95 latency target."
            ).set(target_p95_s)
            registry.gauge(
                "slo_target_error_rate", "Configured error-rate budget."
            ).set(target_error_rate)

    def observe(self, latency_s: float, *, error: bool = False) -> None:
        """One finished request: its latency, and whether it failed."""
        self.latency.observe(latency_s)
        if error:
            self.errors += 1
        self._win.append((error, latency_s > self.target_p95_s))
        if self._g_verdict is not None:
            self.verdict()  # refresh the exported gauges

    @property
    def count(self) -> int:
        return self.latency.count

    def burn_rates(self) -> Dict[str, float]:
        """Windowed burn per budget.  Latency budget: 5% of requests may
        exceed the p95 target.  Error budget: ``target_error_rate``.  A
        zero budget burns infinitely on the first violation."""
        n = len(self._win)
        if not n:
            return {"latency_burn": 0.0, "error_burn": 0.0,
                    "window_error_rate": 0.0, "window_over_rate": 0.0}
        err = sum(1 for e, _ in self._win if e) / n
        over = sum(1 for _, o in self._win if o) / n
        err_burn = (err / self.target_error_rate if self.target_error_rate
                    else (math.inf if err else 0.0))
        return {
            "latency_burn": over / 0.05,
            "error_burn": err_burn,
            "window_error_rate": err,
            "window_over_rate": over,
        }

    def verdict(self) -> Dict[str, Any]:
        """The SLO state now: ``ok`` / ``warn`` / ``breach`` plus the
        numbers behind it (p95 over the recent window, burn rates)."""
        burns = self.burn_rates()
        worst = max(burns["latency_burn"], burns["error_burn"])
        if self.count < self.min_count:
            state = "ok"  # not enough evidence to judge
        elif worst >= 1.0:
            state = "breach"
        elif worst >= self.warn_ratio:
            state = "warn"
        else:
            state = "ok"
        if self._g_latency_burn is not None:
            self._g_latency_burn.set(burns["latency_burn"])
            self._g_error_burn.set(
                burns["error_burn"] if burns["error_burn"] != math.inf
                else float("inf"))
            self._g_verdict.set(float(VERDICTS.index(state)))
        return {
            "verdict": state,
            "count": self.count,
            "errors": self.errors,
            "p95_s": self.latency.quantile(0.95),
            "target_p95_s": self.target_p95_s,
            "target_error_rate": self.target_error_rate,
            **burns,
        }
