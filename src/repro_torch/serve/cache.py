"""Plan/system cache: compile once, serve forever.

The flow's expensive half is planning -- ``plan_chain`` plus the
optional DSE sweep -- and a serving process sees the same program
compiled over and over.  :class:`PlanCache` keys each
:func:`repro_torch.flow.build.compile` call by
``(sha of the post-rewrite program, target name, policy, topology
fingerprint, knob digest)`` (:func:`repro_torch.flow.build.cache_key`) and
returns the cached :class:`~repro_torch.flow.build.CompiledSystem` -- stage
callables, plan, *and* the DSE winner/ranking it was adopted from -- on
a repeat.  Only the front/middle-end (parse + rewrite, needed to
fingerprint the program) re-runs on a hit; ``plan_chain`` does not.

Hit/miss counts export through the standard counter machinery
(``trace.attribution.COUNTER_PLAN_CACHE``) when a tracer is attached.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from ..flow import build


class PlanCache:
    """In-process compile cache over :func:`repro_torch.flow.build.compile`.

    ``max_systems`` FIFO-bounds the cache (a CompiledSystem holds jitted
    stage callables; a long-lived server should not grow one per novel
    program without bound).  ``metrics`` (a ``repro_torch.metrics`` registry)
    adds hit/miss counters and a compile-seconds histogram on top of the
    tracer's ``COUNTER_PLAN_CACHE``.
    """

    def __init__(self, tracer=None, max_systems: int = 64,
                 metrics=None) -> None:
        if max_systems < 1:
            raise ValueError(f"max_systems must be >= 1, got {max_systems}")
        self.tracer = tracer
        self.max_systems = max_systems
        self._systems: Dict[str, build.CompiledSystem] = {}
        self.hits = 0
        self.misses = 0
        self._m_events = self._m_compile = None
        if metrics:
            self._m_events = {
                event: metrics.counter(
                    "plan_cache_total",
                    "Compile calls served from cache (hit) vs compiled "
                    "fresh (miss).", event=event)
                for event in ("hit", "miss")
            }
            self._m_compile = metrics.histogram(
                "plan_cache_compile_seconds",
                "Wall seconds per cache-miss flow compile.")

    def key(self, source: str, **compile_kwargs) -> str:
        return build.cache_key(source, **compile_kwargs)

    def lookup(self, source: str,
               **compile_kwargs) -> Optional[build.CompiledSystem]:
        """The cached system for this compile call, or None.  Does not
        count as a hit/miss (use :meth:`get_or_compile` to serve)."""
        return self._systems.get(self.key(source, **compile_kwargs))

    def get_or_compile(self, source: str,
                       **compile_kwargs) -> build.CompiledSystem:
        """Serve one compile call through the cache.

        Accepts exactly :func:`repro_torch.flow.build.compile`'s keyword
        arguments; on a miss they are forwarded verbatim and the result
        is cached under the call's key.

        ``profile=`` threads through warm hits too: the key excludes it
        (a profile store refines ranking, it does not change what is
        being compiled), so a hit re-applies the store's *current*
        correction to the cached DSE ranking -- traced runs recorded
        since the entry was compiled still reach the served candidates.
        If the refit flips the feasible winner, the entry is stale and
        is recompiled in place.
        """
        key = self.key(source, **compile_kwargs)
        system = self._systems.get(key)
        if system is not None and self._still_fresh(
                system, compile_kwargs.get("profile"),
                compile_kwargs.get("device")):
            self.hits += 1
            self._bump("hit")
            return system
        self.misses += 1
        self._bump("miss")
        t0 = time.perf_counter()
        system = build.compile(source, **compile_kwargs)
        if self._m_compile is not None:
            self._m_compile.observe(time.perf_counter() - t0)
        self._systems[key] = system
        while len(self._systems) > self.max_systems:
            self._systems.pop(next(iter(self._systems)))
        return system

    def _still_fresh(self, system: build.CompiledSystem,
                     profile, device=None) -> bool:
        """Re-apply the profile store's current correction to a cached
        entry's DSE ranking (in place).  True unless the refit promotes
        a *different* feasible plan to the top -- then the cached system
        no longer matches what a fresh compile would serve.  The store is
        keyed for the compile call's ``device``, as the compile keyed
        it."""
        if profile is None or not system.candidates:
            return True
        from ..memory import dse as dse_mod
        from ..trace.profile import ProfileStore

        store = ProfileStore.open(profile)
        if store is None:
            return True
        if device is not None:
            store = store.for_device(device)
        dse_mod.apply_correction(
            system.candidates, store.correction(system.target.name)
        )
        winner = next(
            (c for c in system.candidates if c.plan.feasible), None
        )
        return (winner is None
                or winner.plan.signature == system.plan.signature)

    def _bump(self, what: str) -> None:
        if self._m_events is not None:
            self._m_events[what].inc()
        if self.tracer:
            from ..trace.attribution import COUNTER_PLAN_CACHE

            self.tracer.bump(COUNTER_PLAN_CACHE, {what: 1.0})

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def __len__(self) -> int:
        return len(self._systems)
