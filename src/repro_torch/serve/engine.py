"""The flow-native serving engine: admission waves through the plan's
stage-pipelined dispatch rings.

One engine wraps one :class:`~repro_torch.flow.build.CompiledSystem` and keeps
its :class:`~repro_torch.memory.pipeline.StagePipelineDriver` -- the same
skewed ring ``run_chain`` uses for batch jobs -- alive across requests:

  * :meth:`submit` validates a request's element rows and pushes it on
    the :class:`~repro_torch.serve.queue.AdmissionQueue`; waves of exactly the
    plan's ``E`` elements are fed to the ring as they fill (or when the
    max-latency knob flushes a padded partial wave);
  * the ring holds at most ``window`` waves in flight -- derived from
    the placement's prefetch depths (host staging + pipeline fill) --
    and a submit that would exceed it blocks on ring progress, or
    raises :class:`Backpressure` when ``reject=True``;
  * :meth:`drain` force-flushes and runs the ring dry within a tick
    budget, raising :class:`DrainTimeout` with the undrained requests
    rather than returning silently with work still queued;
    :meth:`shutdown` surfaces :class:`EngineShutdown` on every
    unfinished request instead of wedging them.

Per-wave stage errors raised on the host -- a refused tile, a shape
error, an injected fault -- are captured by the driver
(``capture_errors``) and land on the affected requests' ``error`` field:
one poisoned wave never takes down the ring or unrelated requests.  A
fault on the card (an illegal address, say) is not such an error.  It
is sticky: the CUDA context is poisoned and every later call of the
process fails with it, so no later wave could be right.  The driver
synchronises once after each captured error, and lets a device fault
propagate out of :meth:`ServeEngine.submit`, :meth:`~ServeEngine.poll`
or :meth:`~ServeEngine.drain`: it ends the run loudly instead of marking
one wave.  A process that must keep serving restarts.

Execution is ``cfd.simulation.run_chain``'s over one group: the device
pool (``devices=``; every visible card by default, ``device`` the
one-slot shorthand, ``"cpu"`` for the host), as the reference serves
over its whole element mesh.  The shared operands are put once on each
distinct device, each wave's element rows are sharded over the pool's
slots through the pinned :class:`~repro_torch.memory.pipeline.HostStager`
ring (one ring a card), every stage runs the chain's kernels on each
shard, and each wave's outputs are joined in slot order on the first
slot's device, come back whole and are sliced per request.  The kernels and the plain stages
compute every element alone, in a fixed order, so engine outputs are
bitwise-identical to per-request serial runs of the same system.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..memory import chain as memchain
from ..memory.channels import resolve_devices
from ..memory.pipeline import HostStager, StagePipelineDriver
from .queue import AdmissionQueue, ServeRequest, Wave


def _join(shards):
    """A wave's output shards as one tensor on the first slot's device
    (the shard itself for one slot): the join runs on the card, so one
    copy brings the wave back, as on one slot."""
    if len(shards) == 1:
        return shards[0]
    return torch.cat([s.to(shards[0].device) for s in shards])


class Backpressure(RuntimeError):
    """submit() would exceed the in-flight window (reject mode)."""


class EngineShutdown(RuntimeError):
    """The engine shut down with this request still unfinished."""


class DrainTimeout(RuntimeError):
    """drain() exhausted its tick budget with requests still in flight.

    ``undrained`` holds the affected :class:`ServeRequest` objects --
    the caller decides whether to extend the budget or shut down."""

    def __init__(self, undrained: List[ServeRequest]) -> None:
        self.undrained = list(undrained)
        rids = ", ".join(f"r{r.rid}" for r in self.undrained)
        super().__init__(
            f"drain tick budget exhausted with {len(self.undrained)} "
            f"request(s) unfinished: {rids}"
        )


class ServeEngine:
    """Long-running request service over one compiled system.

    ``window=None`` derives the bounded in-flight window from the plan's
    pipeline spec: ``depths[0]`` host-staged waves + the fill/drain
    skew + 2 live waves.  ``reject=True`` turns a full window into
    :class:`Backpressure` instead of blocking on ring progress.
    ``max_wait_s`` is the coalescing latency knob: an undersized wave is
    flushed (padded) once its oldest request has waited that long.
    ``tracer`` records per-request spans plus the standard ring spans
    and the serving counters; ``monitor``/``latency`` observe retire
    cadence and request latency.  ``seed`` fixes the synthesized
    batch-invariant shared operands (pass ``shared`` to pin them).
    ``devices`` is the pool each wave is element-sharded over (every
    visible card by default; the plan's E must shard evenly over it);
    ``device`` is the one-slot shorthand (``"cpu"`` for the host).

    ``metrics`` (a :class:`repro_torch.metrics.MetricsRegistry`; None or
    :data:`~repro_torch.metrics.NULL_REGISTRY` = off) turns on the always-on
    telemetry: request lifecycle counters, in-flight/queue gauges, and
    per-request latency *decomposed* into queue-wait (submit to first
    wave fed) vs wave-execution (first feed to retire), with the
    execution share attributable to zero-padding tracked separately.
    ``slo`` (a :class:`repro_torch.metrics.SLOTracker`) is fed every finished
    request.  Both only observe -- outputs stay bitwise-identical to an
    unmetered engine.
    """

    def __init__(self, system, *, window: Optional[int] = None,
                 reject: bool = False, max_wait_s: Optional[float] = None,
                 tracer=None, monitor=None, latency=None, seed: int = 0,
                 shared: Optional[Dict[str, np.ndarray]] = None,
                 clock=time.monotonic, metrics=None, slo=None,
                 devices=None, device=None) -> None:
        # lazy: cfd builds on flow
        from ..cfd.simulation import _shared_host, chain_stage_fns, replicate

        self.system = system
        #: the slots each wave is sharded over, and the first one's device
        self.devices = pool = resolve_devices(devices, device)
        self.device = pool[0]
        chain: memchain.ProgramChain = system.chain
        plan: memchain.ChainPlan = system.plan
        self.chain = chain
        self.plan = plan
        self.tracer = tracer
        self.latency = latency
        self.metrics = metrics
        self.slo = slo
        E = plan.batch_elements
        self.batch_elements = E
        self._m_req = self._m_lat = self._m_pad = None
        self._m_waves = self._m_ticks = self._m_admitted_elems = None
        self._m_pad_overhead = None
        self._g_inflight_req = self._g_inflight_waves = None
        if metrics:
            self._m_req = {
                e: metrics.counter(
                    "serve_requests_total",
                    "Requests by lifecycle event (admitted counts "
                    "requests whose last slice entered a wave).",
                    event=e)
                for e in ("submitted", "admitted", "completed",
                          "failed", "rejected")
            }
            self._m_waves = metrics.counter(
                "serve_waves_total", "Coalesced E-element waves fed.")
            self._m_ticks = metrics.counter(
                "serve_ticks_total", "Ring ticks driven by the engine.")
            self._m_admitted_elems = metrics.counter(
                "serve_admitted_elements_total",
                "Real (non-pad) element rows fed across all waves.")
            self._m_pad = {
                kind: metrics.counter(
                    "serve_pad_elements_total",
                    "Zero-pad rows fed: wave = undersized admission "
                    "waves, plan = the plan's own E block padding.",
                    kind=kind)
                for kind in ("wave", "plan")
            }
            metrics.gauge(
                "serve_batch_elements",
                "The plan's wave size E in element rows.").set(float(E))
            self._g_inflight_req = metrics.gauge(
                "serve_in_flight_requests",
                "Submitted requests not yet finished.")
            self._g_inflight_waves = metrics.gauge(
                "serve_in_flight_waves", "Waves currently in the ring.")
            self._m_lat = {
                phase: metrics.histogram(
                    "serve_request_latency_seconds",
                    "Per-request latency, decomposed: total = queue "
                    "(submit to first feed) + execute (first feed to "
                    "retire).", phase=phase)
                for phase in ("total", "queue", "execute")
            }
            self._m_pad_overhead = metrics.histogram(
                "serve_request_pad_overhead_seconds",
                "Execution time attributable to wave zero-padding: each "
                "of a request's waves charges pad/E of its wall time.")

        pipe = plan.pipeline
        if pipe is None:  # legacy plan: derive from the stage Ks
            pipe = memchain.derive_pipeline(
                [sp.prefetch_depth for sp in plan.stages]
            )
        depths = list(pipe.stage_depths)
        if len(depths) != len(chain.stages):
            raise ValueError(
                f"plan has {len(depths)} stage depths but the compiled "
                f"chain has {len(chain.stages)} stages; serve the system "
                "the flow actually compiled"
            )
        pipelined = (pipe.pipelined and len(depths) > 1
                     and any(d > 0 for d in depths[1:]))
        if not pipelined:  # serial schedule: host staging only
            depths = [max(depths)] + [0] * (len(chain.stages) - 1)
        self.pipelined = pipelined
        if window is None:
            window = depths[0] + pipe.fill_batches + 2
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self.reject = reject

        # -- expected request shape -----------------------------------------
        self.in_specs: Dict[str, tuple] = {
            f"{s.name}.{n}": tuple(node.shape)
            for i, s in enumerate(chain.stages)
            for n, node in chain.host_element_inputs(i)
        }
        self.out_names = [
            f"{s.name}.{n}"
            for i, s in enumerate(chain.stages)
            for n, _ in chain.chain_outputs(i)
        ]

        # -- the execution substrate: run_chain's, one group over the pool -
        self.shared_host: Dict[str, np.ndarray] = _shared_host(
            chain, seed, shared)
        shared_dev = replicate(self.shared_host, pool)
        stager = HostStager(pool, slots=depths[0] + 1)

        def stage_batch(batch):
            if tracer:
                from ..trace.attribution import (COUNTER_CHANNEL_BYTES,
                                                 COUNTER_PAD_ELEMENTS,
                                                 host_channel_bytes)

                tracer.bump(COUNTER_CHANNEL_BYTES, {
                    str(c): float(b)
                    for c, b in host_channel_bytes(plan.buffers).items()
                })
                if plan.batch_pad_elements:
                    tracer.bump(COUNTER_PAD_ELEMENTS, {
                        "pad": float(plan.batch_pad_elements)
                    })
            return stager(batch)

        out_names = self.out_names
        self.driver = StagePipelineDriver(
            chain_stage_fns(chain, plan, shared_dev,
                            [pool] * len(chain.stages)),
            stage_fn=stage_batch,
            depths=depths,
            reduce_fn=lambda live: {q: _join(live[q]) for q in out_names},
            tracer=tracer,
            monitor=monitor,
            stage_names=[s.name for s in chain.stages],
            capture_errors=True,
            metrics=metrics,
            metrics_labels={"plan": plan.signature[:12]},
            device=pool,
        )

        self.queue = AdmissionQueue(E, max_wait_s=max_wait_s, clock=clock,
                                    metrics=metrics)
        #: batch index -> (wave parts, feed timestamp, wave pad rows)
        self._wave_parts: Dict[int, tuple] = {}
        self._spans: Dict[int, Any] = {}
        self._request_track = 1 + len(chain.stages)
        self._next_rid = 0
        self._closed = False
        #: running tallies (also exported as counters when traced)
        self.stats: Dict[str, int] = {
            "submitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "waves": 0, "pad_elements": 0, "plan_pad_elements": 0,
            "ticks": 0,
        }

    # -- submission ----------------------------------------------------------
    def submit(self, inputs: Dict[str, np.ndarray]) -> ServeRequest:
        """Queue one request; admits any waves that are due.

        ``inputs`` maps every qualified host stream name to an array of
        ``n`` element rows (the request's size; any ``n >= 1`` works --
        coalescing and padding are the engine's job).  Returns the
        :class:`ServeRequest` to poll for ``outputs``/``error``.
        """
        if self._closed:
            raise RuntimeError("engine is shut down")
        got, want = set(inputs), set(self.in_specs)
        if got != want:
            raise ValueError(
                f"request inputs {sorted(got)} != chain host streams "
                f"{sorted(want)}"
            )
        rows = {q: np.asarray(v, np.float32) for q, v in inputs.items()}
        sizes = {v.shape[0] for v in rows.values()}
        if len(sizes) != 1 or min(sizes) < 1:
            raise ValueError(
                f"request inputs disagree on element count: "
                f"{ {q: v.shape[0] for q, v in rows.items()} }"
            )
        for q, v in rows.items():
            if v.shape[1:] != self.in_specs[q]:
                raise ValueError(
                    f"request input {q!r} rows have shape {v.shape[1:]}, "
                    f"chain expects {self.in_specs[q]}"
                )
        n = sizes.pop()
        req = ServeRequest(rid=self._next_rid, inputs=rows, n_elements=n)
        self._next_rid += 1
        self.queue.push(req)
        self.stats["submitted"] += 1
        self._bump_requests("submitted")
        if self._g_inflight_req is not None:
            self._g_inflight_req.inc()
        if self.tracer:
            from ..trace.attribution import CAT_REQUEST

            track = self._request_track + req.rid
            self.tracer.name_track(track, f"request r{req.rid}")
            self._spans[req.rid] = self.tracer.begin(
                f"r{req.rid}", CAT_REQUEST, track, elements=n
            )
        self._admit(block=not self.reject, rejectable=req)
        self._tick()
        return req

    def poll(self) -> None:
        """One service beat for a long-running loop: admit any due wave
        (max-latency flushes included) and advance the ring one tick."""
        self._admit(block=not self.reject)
        self._tick()

    # -- draining ------------------------------------------------------------
    def drain(self, max_ticks: Optional[int] = None) -> None:
        """Flush partial waves and run the ring dry.

        Every submitted request is finished (``outputs`` or ``error``)
        on return.  If ``max_ticks`` is exhausted first, raises
        :class:`DrainTimeout` carrying the undrained requests -- never
        a silent return with work still queued."""
        if max_ticks is None:
            waves_left = (len(self._wave_parts)
                          + -(-max(1, self.queue.pending_elements)
                              // self.batch_elements))
            max_ticks = 8 * (waves_left + self.window + 4) + 16
        ticks = 0
        while True:
            while (self.queue.ready(force=True)
                   and len(self._wave_parts) < self.window):
                wave = self.queue.pop_wave(force=True)
                self._feed(wave)
            if self.driver.idle and not self.queue.pending_requests:
                self._collect()
                return
            if ticks >= max_ticks:
                raise DrainTimeout(
                    [r for r in self._live_requests() if not r.done]
                )
            self._tick()
            ticks += 1

    def shutdown(self) -> List[ServeRequest]:
        """Stop serving now.  Unfinished requests -- queued or mid-ring
        -- get :class:`EngineShutdown` as their error and are returned;
        nothing is left silently wedged.  (Call :meth:`drain` first for
        a graceful stop.)"""
        self._collect()
        leftovers = [r for r in self._live_requests() if not r.done]
        for r in leftovers:
            r.error = EngineShutdown(
                f"engine shut down with request r{r.rid} unfinished"
            )
            r.parts_done = r.parts
            self._finish(r)
        self._wave_parts.clear()
        self.queue._q.clear()
        self.queue._gauge_depth()
        if self._g_inflight_waves is not None:
            self._g_inflight_waves.set(0.0)
        self.driver.close()
        self._closed = True
        return leftovers

    # -- internals -----------------------------------------------------------
    def _live_requests(self) -> List[ServeRequest]:
        seen: Dict[int, ServeRequest] = {}
        for parts, _, _ in self._wave_parts.values():
            for part in parts:
                seen.setdefault(part.request.rid, part.request)
        for r in self.queue.pending_requests:
            seen.setdefault(r.rid, r)
        return [seen[rid] for rid in sorted(seen)]

    def _admit(self, *, block: bool,
               rejectable: Optional[ServeRequest] = None) -> None:
        while self.queue.ready():
            self._collect()
            if len(self._wave_parts) >= self.window:
                if not block:
                    if rejectable is not None and self.queue.remove(
                            rejectable):
                        rejectable.error = Backpressure(
                            f"in-flight window full "
                            f"({self.window} waves)"
                        )
                        self.stats["rejected"] += 1
                        self._bump_requests("rejected")
                        self._finish(rejectable, count=False)
                        raise rejectable.error
                    return
                self._tick()  # ring progress frees a window slot
                continue
            self._feed(self.queue.pop_wave())

    def _feed(self, wave: Wave) -> None:
        E = self.batch_elements
        batch = {
            q: np.zeros((E,) + shape, np.float32)
            for q, shape in self.in_specs.items()
        }
        for part in wave.parts:
            for q, arr in part.request.inputs.items():
                batch[q][part.dst:part.dst + part.n] = arr[part.lo:part.hi]
        feed_t = self.queue.clock()
        for part in wave.parts:
            if part.request.admitted_s == 0.0:
                part.request.admitted_s = feed_t
        k = self.driver.feed(batch)
        self._wave_parts[k] = (wave.parts, feed_t, wave.pad_elements)
        self.stats["waves"] += 1
        self.stats["pad_elements"] += wave.pad_elements
        self.stats["plan_pad_elements"] += self.plan.batch_pad_elements
        fully_admitted = sum(
            1 for p in wave.parts if p.hi == p.request.n_elements
        )
        if self._m_waves is not None:
            self._m_waves.inc()
            self._m_admitted_elems.inc(float(E - wave.pad_elements))
            if wave.pad_elements:
                self._m_pad["wave"].inc(float(wave.pad_elements))
            if self.plan.batch_pad_elements:
                self._m_pad["plan"].inc(float(self.plan.batch_pad_elements))
            self._g_inflight_waves.set(float(len(self._wave_parts)))
        if self.tracer:
            from ..trace.attribution import (COUNTER_PAD_ELEMENTS,
                                             COUNTER_SERVE_WAVES)

            self.tracer.bump(COUNTER_SERVE_WAVES, {"waves": 1.0})
            if wave.pad_elements:
                self.tracer.bump(COUNTER_PAD_ELEMENTS, {
                    "wave": float(wave.pad_elements)
                })
        if fully_admitted:
            self._bump_requests("admitted", float(fully_admitted))

    def _tick(self) -> None:
        self.driver.tick()
        self.stats["ticks"] += 1
        if self._m_ticks is not None:
            self._m_ticks.inc()
        self._collect()

    def _collect(self) -> None:
        retired = False
        for k, value in self.driver.take():
            retired = True
            parts, feed_t, pad = self._wave_parts.pop(k)
            if pad:
                # charge each rider its share of the wave's wall time
                # spent computing zero rows: pad/E of (feed -> retire)
                wave_wall = self.queue.clock() - feed_t
                for part in parts:
                    part.request.pad_overhead_s += (
                        wave_wall * pad / self.batch_elements
                    )
            failed = isinstance(value, BaseException)
            if not failed:  # the wave's outputs, back on the host
                value = {q: v.numpy() for q, v in value.items()}
            for part in parts:
                req = part.request
                if failed:
                    if req.error is None:
                        req.error = value
                else:
                    if req.outputs is None:
                        req.outputs = {
                            q: np.empty(
                                (req.n_elements,) + v.shape[1:], v.dtype
                            )
                            for q, v in value.items()
                        }
                    for q, v in value.items():
                        req.outputs[q][part.lo:part.hi] = (
                            v[part.dst:part.dst + part.n]
                        )
                req.parts_done += 1
                if req.done:
                    self._finish(req)
        if retired and self._g_inflight_waves is not None:
            self._g_inflight_waves.set(float(len(self._wave_parts)))

    def _finish(self, req: ServeRequest, *, count: bool = True) -> None:
        if req.completed_s:
            return
        req.completed_s = self.queue.clock()
        total_s = req.completed_s - req.submitted_s
        if self.latency is not None and req.error is None:
            self.latency.record(total_s)
        if self.slo is not None and count:
            self.slo.observe(total_s, error=req.error is not None)
        if self._m_lat is not None and count and req.error is None:
            # decomposition: total == queue + execute by construction
            # (admitted_s sits between submit and complete)
            admitted = req.admitted_s or req.completed_s
            self._m_lat["queue"].observe(admitted - req.submitted_s)
            self._m_lat["execute"].observe(req.completed_s - admitted)
            self._m_lat["total"].observe(total_s)
            self._m_pad_overhead.observe(req.pad_overhead_s)
        if count:
            what = "failed" if req.error is not None else "completed"
            self.stats[what] += 1
            self._bump_requests(what)
        if self._g_inflight_req is not None:
            self._g_inflight_req.dec()
        sp = self._spans.pop(req.rid, None)
        if sp is not None:
            if req.error is not None:
                sp.args["error"] = type(req.error).__name__
            self.tracer.end(sp)

    def _bump_requests(self, what: str, n: float = 1.0) -> None:
        if self._m_req is not None:
            self._m_req[what].inc(n)
        if self.tracer:
            from ..trace.attribution import COUNTER_SERVE_REQUESTS

            self.tracer.bump(COUNTER_SERVE_REQUESTS, {what: n})
