"""Transfer + stage pipelining: the generalized ping/pong engine on CUDA
streams.

The paper overlaps host->device transfer of batch k+1 with compute of
batch k through a pair of HBM channel buffers (Fig. 14a), and its
multi-accelerator system keeps *every* pipeline stage busy on a
different batch simultaneously.  On the card the same overlap comes
from three tricks, packaged here behind generic drivers:

  1. :class:`HostStager` copies each host batch into a ring of pinned
     buffers and on to the device with ``non_blocking`` copies on a side
     stream; an event orders the compute stream after the copy, so the
     transfer of upcoming batches runs while the current one computes.
  2. The host sync -- the ``.cpu()`` of a batch's reduced result -- is
     deferred by one batch, so the compute stream's queue never drains.
  3. The stages of a multi-operator chain are dispatched *skewed*:
     stage i of batch k in the same tick as stage i+1 of batch k-1.

``depth`` is the plan's prefetch K: 0 = fully serial (stage, compute,
sync -- the paper's baseline), 1 = classic double buffering, K>1 =
deeper staging that also rides out host-side jitter.

:func:`run_pipelined` is the single-stage K-deep engine;
:func:`run_stage_pipelined` generalizes it to a whole chain with one
dispatch ring per stage, handing device-resident inter-stage values from
producer to consumer without host round-trips.  Both build on
:class:`StagePipelineDriver`, the reentrant feed/tick state machine.

:func:`reblock_batched_fn` is the re-blocking handoff of a plan with
per-stage batch sizes: a stage runs its own E_s inside the chain batch.

Element-axis placement runs over a *device pool*: an ordered list of
slots (torch devices; an entry may repeat, so ``[cuda:0, cuda:0]`` is
two slots on one card and ``["cpu", "cpu"]`` two on the host), the
port's counterpart of the reference's element mesh.  A stage's element
batch is split over its group of slots in contiguous equal chunks of
dim 0 (:func:`element_chunks`, the layout of the reference's
``P("elements")``), one shard a slot; :class:`HostStager` copies each
shard to its slot through one pinned ring per distinct card, and
:func:`reshard` re-lays a device-resident stream over another group.
:func:`placement_meshes` maps a :class:`~repro_torch.memory.placement.PlacementPlan`
onto the pool, and the drivers' ``place_fns`` hook re-shards the
handoff before a stage on another group consumes it: one dispatch ring
per device group.

Both drivers take the reference's observers: a ``tracer`` (span per
staging, dispatch slot, cross-group reshard and retire sync, on one
track per stage), a ``monitor`` (retire cadence, straggler flags) and a
``metrics`` registry (per-stage dispatch and reshard histograms, stall
counters).  A CUDA launch returns once the kernel is queued, so with a
tracer on one card each (stage, batch) slot is bracketed by CUDA events
on the compute stream, read when the batch retires, and its spans carry
the device's times (the host-clock duration stays as the ``host_s``
arg); no launch is synchronised for it.  A pool over several cards has
no one stream to read, so its spans keep the host clock.
:class:`StagePipelineDriver` can capture a batch's host-side failure
(``capture_errors``) instead of raising.
"""
from __future__ import annotations

import time
from collections import deque
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch

# Span categories (the ``repro_torch.trace.attribution`` vocabulary).  The
# tracer is duck-typed -- any object with begin/end/span/name_track/bump,
# falsy when disabled -- so this module never imports
# ``repro_torch.trace`` and the executors stay import-light.
_CAT_SLOT = "slot"
_CAT_DISPATCH = "dispatch"
_CAT_HANDOFF = "handoff"
_CAT_STAGE_HOST = "stage-host"
_CAT_SYNC = "sync"
_HOST_TRACK = 0


def element_chunks(n: int, parts: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of each of ``parts`` contiguous equal chunks of ``n``
    rows: the layout of the reference's ``P("elements")`` sharding.
    Raises when ``parts`` does not divide ``n``, as the reference's
    ``device_put`` does for such a batch."""
    if parts < 1 or n % parts:
        raise ValueError(
            f"a batch of {n} elements does not shard evenly over {parts} "
            "slots; plan an E that the group sizes divide"
        )
    c = n // parts
    return [(j * c, (j + 1) * c) for j in range(parts)]


def _slot_devices(devices) -> Tuple[torch.device, ...]:
    """One device or a sequence of slot devices, as a tuple."""
    if isinstance(devices, (str, torch.device)):
        return (torch.device(devices),)
    return tuple(torch.device(d) for d in devices)


def reshard(shards: Sequence[torch.Tensor],
            devices: Sequence) -> Tuple[torch.Tensor, ...]:
    """Element shards re-laid over the slots ``devices``: chunk ``j`` of
    :func:`element_chunks` on ``devices[j]``.  A layout that already
    matches comes back as it is; otherwise each new chunk is the rows of
    the old shards it covers -- a view where one shard on the same
    device covers it (no copy), else the pieces moved to its device and
    joined with ``torch.cat``.  Rows keep their order, so gathering the
    result gives the same batch bit for bit."""
    devs = _slot_devices(devices)
    if tuple(s.device for s in shards) == devs:
        return tuple(shards)
    src, lo = [], 0
    for s in shards:
        src.append((lo, lo + s.shape[0], s))
        lo += s.shape[0]
    out = []
    for (a, b), dev in zip(element_chunks(lo, len(devs)), devs):
        pieces = [s[max(a, s_lo) - s_lo:min(b, s_hi) - s_lo].to(dev)
                  for s_lo, s_hi, s in src if max(a, s_lo) < min(b, s_hi)]
        out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces))
    return tuple(out)


def placement_meshes(
    placement, devices: Optional[Sequence[Any]] = None
) -> Optional[List[Tuple[Any, ...]]]:
    """Per-stage groups of pool slots for a PlacementPlan.

    Maps each stage's topology device ids onto the pool ``devices``
    (default :func:`~repro_torch.memory.channels.resolve_devices`: every
    visible card).  Returns None when the placement does not fit the
    pool (more devices than slots) or is the degenerate single-group
    case (every stage on the one slot 0) -- callers then fall back to one
    group over the whole pool, which is bitwise-identical by
    construction.  Slots are told apart by their index, not by the
    device they name: ``[cuda:0, cuda:0]`` is two slots."""
    if placement is None:
        return None
    if devices is None:
        from .channels import resolve_devices  # lazy: channels imports torch

        devices = resolve_devices()
    devices = list(devices)
    used = placement.devices_used
    if not used or used[-1] >= len(devices):
        return None  # placement planned for a bigger machine than this
    if (len({sp.devices for sp in placement.stages}) == 1
            and len(placement.stages[0].devices) == 1):
        return None  # every stage on one slot: the single-group path
    return [tuple(devices[d] for d in sp.devices) for sp in placement.stages]


def reblock_batched_fn(
    fn: Callable[..., Dict[str, Any]],
    element_keys: Sequence[str],
    sub_elements: int,
    *,
    outputs: Optional[Mapping[str, Tuple[int, ...]]] = None,
) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """Re-blocking handoff: run a batched dict->dict stage fn at its own
    (smaller) E_s inside a chain batch of E elements.

    The wrapper slices every element-keyed tensor along dim 0 into
    ``sub_elements`` chunks (views, on the device) and runs ``fn`` per
    chunk (shared operands pass through whole); the handoff never leaves
    the device.  With ``outputs`` (each output's per-element shape) the
    wrapper allocates the chain batch's outputs once, in the dtype and on
    the device of the element inputs, and ``fn`` writes each chunk into
    its slice through ``out=`` (the kernel adapters take it), so no copy
    is made; without, the chunks' outputs are joined with ``torch.cat``,
    a copy of every output.  Elements are independent along the batch
    axis and the kernels sum in a fixed order, so the result is
    bitwise-equal to one full-batch call; only the dispatch granularity
    changes.  A batch no larger than ``sub_elements`` calls ``fn``
    untouched."""
    keys = frozenset(element_keys)
    sub = max(1, int(sub_elements))

    def reblocked(env: Dict[str, Any]) -> Dict[str, Any]:
        first = next((env[k] for k in env if k in keys), None)
        n = None if first is None else first.shape[0]
        if n is None or n <= sub:
            return fn(env)
        chunks = [
            (lo, {k: (v[lo:lo + sub] if k in keys else v)
                  for k, v in env.items()})
            for lo in range(0, n, sub)
        ]
        if outputs is None:
            outs = [fn(c) for _, c in chunks]
            return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        full = {
            k: torch.empty((n,) + tuple(shape), dtype=first.dtype,
                           device=first.device)
            for k, shape in outputs.items()
        }
        for lo, c in chunks:
            fn(c, out={k: v[lo:lo + sub] for k, v in full.items()})
        return full

    return reblocked


def prefetch(
    batches: Iterable[Any],
    stage_fn: Callable[[Any], Any],
    depth: int,
) -> Iterator[Any]:
    """Yield staged batches while keeping up to ``depth`` staged ahead.

    ``stage_fn`` starts the (asynchronous) host->device transfer; the
    transfer of staged-ahead batches proceeds while the consumer computes
    on the current one.
    """
    if depth < 0:
        raise ValueError(f"prefetch depth must be >= 0, got {depth}")
    q: deque = deque()
    for item in batches:
        q.append(stage_fn(item))
        if len(q) > depth:
            yield q.popleft()
    while q:
        yield q.popleft()


class Staged:
    """One staged batch: per name, its element shards (one tensor per slot
    of the group that reads it), plus the events their host->device
    copies record, one per card (none on the CPU).  :meth:`shards` makes
    each card's current stream wait for its copy before handing them
    out; :meth:`arrays` is the one-slot view."""

    __slots__ = ("_shards", "_ready")

    def __init__(self, shards: Dict[str, Tuple[torch.Tensor, ...]],
                 ready: Sequence[Tuple[torch.device,
                                       torch.cuda.Event]] = ()) -> None:
        self._shards = shards
        self._ready = tuple(ready)

    def shards(self) -> Dict[str, Tuple[torch.Tensor, ...]]:
        """The shards by name, once each card's current stream waits for
        their copy."""
        for device, event in self._ready:
            torch.cuda.current_stream(device).wait_event(event)
        return self._shards

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The device tensors by name, for a batch staged to one slot."""
        got = self.shards()
        if any(len(v) != 1 for v in got.values()):
            raise ValueError("the batch is sharded over several slots; "
                             "read shards()")
        return {k: v[0] for k, v in got.items()}


class _PinnedRing:
    """One card's ring of pinned host buffers and its copy stream."""

    def __init__(self, device: torch.device, slots: int) -> None:
        self.device = device
        self.slots: List[Optional[Tuple[Dict[Tuple[str, int], torch.Tensor],
                                        torch.cuda.Event]]] = (
            [None] * max(1, slots))
        self.next = 0
        self.copy_stream = torch.cuda.Stream(device)

    def copy(self, parts, out) -> torch.cuda.Event:
        """Copy each ``(name, shard, rows)`` of ``parts`` through the next
        pinned slot to a fresh tensor on the card, into ``out[name][shard]``;
        returns the event the copies record."""
        j = self.next
        self.next = (j + 1) % len(self.slots)
        held = self.slots[j]
        pinned: Dict[Tuple[str, int], torch.Tensor] = {}
        if held is not None:
            held[1].synchronize()  # the slot's last copy has left the host
            pinned = held[0]
        fresh: Dict[Tuple[str, int], torch.Tensor] = {}
        for name, shard, rows in parts:
            h = torch.from_numpy(np.ascontiguousarray(rows))
            buf = pinned.get((name, shard))
            if buf is None or buf.shape != h.shape or buf.dtype != h.dtype:
                buf = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
            buf.copy_(h)
            fresh[(name, shard)] = buf
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            for (name, shard), buf in fresh.items():
                d = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
                d.copy_(buf, non_blocking=True)
                d.record_stream(compute)
                out[name][shard] = d
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        self.slots[j] = (fresh, ready)
        return ready


class HostStager:
    """Host batches (dicts of numpy arrays) to element shards on the slots
    of a device pool.

    ``devices`` is one device or a sequence of slots; every name is split
    over them (:func:`element_chunks`) unless ``layout`` gives the name
    its own slots (a chain stages each host stream to the group of the
    stage that reads it).  Shards bound for a CUDA card go through that
    card's ring of pinned host buffers -- one ring a card, however many
    slots name it, so repeated slots pin no more than the batch -- and on
    to freshly allocated device tensors with ``non_blocking`` copies on
    the ring's side stream; the copy's event is recorded so the
    consumer's stream waits for it (:meth:`Staged.shards`).  A pinned
    slot is refilled only after its previous copy's event has completed,
    and each device tensor is marked as used by the card's compute stream
    (``record_stream``) so the caching allocator never hands its memory
    out while a kernel may still read it.  On the CPU a shard is a
    tensor that shares the numpy array's memory.
    """

    def __init__(self, devices, slots: int = 2, *,
                 layout: Optional[Mapping[str, Sequence]] = None) -> None:
        self.devices = _slot_devices(devices)
        self.layout = {k: _slot_devices(v) for k, v in (layout or {}).items()}
        cards = dict.fromkeys(
            d for devs in (self.devices, *self.layout.values())
            for d in devs if d.type == "cuda")
        self._rings = {d: _PinnedRing(d, slots) for d in cards}

    def __call__(self, batch: Dict[str, np.ndarray]) -> Staged:
        out: Dict[str, List[Optional[torch.Tensor]]] = {}
        to_card: Dict[torch.device, List[Tuple[str, int, np.ndarray]]] = {}
        for name, v in batch.items():
            devs = self.layout.get(name, self.devices)
            out[name] = [None] * len(devs)
            chunks = element_chunks(v.shape[0], len(devs))
            for j, ((lo, hi), dev) in enumerate(zip(chunks, devs)):
                rows = v if len(devs) == 1 else v[lo:hi]
                if dev.type == "cuda":
                    to_card.setdefault(dev, []).append((name, j, rows))
                else:
                    out[name][j] = torch.from_numpy(np.ascontiguousarray(rows))
        ready = [(dev, self._rings[dev].copy(parts, out))
                 for dev, parts in to_card.items()]
        return Staged({k: tuple(v) for k, v in out.items()}, ready)


def to_host(value: Any) -> Any:
    """The deferred host sync: tensors (in dicts, lists or tuples) come
    back with ``.cpu()``, which waits for the work that produced them."""
    if isinstance(value, torch.Tensor):
        return value.cpu()
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_host(v) for v in value)
    return value


class _DeviceClock:
    """Device times for traced dispatch spans on a CUDA card.

    An anchor event is recorded on the idle compute stream (after one
    synchronise, when the clock is made) beside a reading of the
    tracer's clock; each traced slot records a start and an end event
    on the compute stream.  :meth:`resolve` runs when the slot's batch
    retires -- its work has finished by then -- and moves the slot's
    spans onto the device timeline: ``t0``/``t1`` become the anchor's
    host time plus each event's elapsed time from the anchor, and the
    host-clock duration is kept as the ``host_s`` arg.  Events on one
    stream complete in order, so one stage's spans stay disjoint and a
    slot and its dispatch span share one interval: the trace still
    nests.  The driver makes the stream wait for a staged batch's host
    copy before it records a slot's start event, so the interval is the
    stage's own work, not the copy it waits for."""

    def __init__(self, tracer, device: torch.device) -> None:
        self.device = device
        torch.cuda.synchronize(device)
        self._anchor = torch.cuda.Event(enable_timing=True)
        self._anchor.record(torch.cuda.current_stream(device))
        self._t_anchor = tracer.clock()
        self._pending: Dict[int, List[Tuple[Any, Any, Tuple[Any, ...]]]] = {}

    def mark(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def close(self, k: int, start: torch.cuda.Event, spans) -> None:
        """Record the end event of batch ``k``'s slot, opened by ``start``."""
        self.interval(k, start, self.mark(), spans)

    def interval(self, k: int, start: torch.cuda.Event,
                 end: torch.cuda.Event, spans) -> None:
        """Give ``spans`` of batch ``k`` the device interval between two
        recorded events."""
        self._pending.setdefault(k, []).append((start, end, tuple(spans)))

    def resolve(self, k: int) -> None:
        for start, end, spans in self._pending.pop(k, ()):
            end.synchronize()
            t0 = self._t_anchor + self._anchor.elapsed_time(start) / 1e3
            t1 = self._t_anchor + self._anchor.elapsed_time(end) / 1e3
            for sp in spans:
                sp.args["host_s"] = sp.duration
                sp.t0, sp.t1 = t0, t1


def _physical(device) -> Tuple[torch.device, ...]:
    """The distinct devices of one device or a pool, in order (none for
    None)."""
    if device is None:
        return ()
    return tuple(dict.fromkeys(_slot_devices(device)))


def _device_clock(tracer, device) -> Optional[_DeviceClock]:
    """A :class:`_DeviceClock` for a tracer on one CUDA card (``device``
    is a device or a pool whose slots all name it), else None: the host
    clock is the only clock on the CPU, and a pool over several cards has
    no one stream to read."""
    devs = _physical(device)
    if not tracer or len(devs) != 1 or devs[0].type != "cuda":
        return None
    return _DeviceClock(tracer, devs[0])


def _traced_stage_fn(stage_fn: Callable[[Any], Any], tracer) -> Callable:
    """Wrap the staging fn so each host->device stage gets a host-track
    span (batch index = call order, which is staging order)."""
    counter = [0]

    def staged(item: Any) -> Any:
        j = counter[0]
        counter[0] += 1
        with tracer.span(f"stage b{j}", _CAT_STAGE_HOST, _HOST_TRACK,
                         batch=j):
            return stage_fn(item)

    return staged


def run_pipelined(
    compute_fn: Callable[[Any], Any],
    batches: Iterable[Any],
    *,
    stage_fn: Callable[[Any], Any] = lambda x: x,
    depth: int = 1,
    reduce_fn: Optional[Callable[[Any], Any]] = None,
    defer_sync: Optional[bool] = None,
    tracer=None,
    stage_name: str = "compute",
    device=None,
) -> List[Any]:
    """Run every batch through ``compute_fn`` with K-deep staging.

    Returns the realized (host-side) per-batch results, in order.

    ``reduce_fn`` maps a device result to the (small) value to realize --
    e.g. a checksum scalar -- so full batches never transfer back.
    ``defer_sync`` delays each host sync by one batch so compute k+1 is
    enqueued before blocking on k (defaults to on whenever ``depth > 0``;
    forcing it off gives the paper's serial baseline).

    ``tracer`` (a ``repro_torch.trace.Tracer``; None/NULL = off) records
    one staging span per batch on the host track, one dispatch span per
    batch on track 1, and one sync span per retire; with ``device`` one
    CUDA card (or a pool of slots on it) the dispatch spans carry the
    device's times.  Results are identical either way (spans only
    observe).
    """
    if defer_sync is None:
        defer_sync = depth > 0
    clock = _device_clock(tracer, device)
    if tracer:
        tracer.name_track(_HOST_TRACK, "host")
        tracer.name_track(1, stage_name)
        stage_fn = _traced_stage_fn(stage_fn, tracer)

    def sync_get(value: Any, j: int) -> Any:
        if not tracer:
            return to_host(value)
        with tracer.span(f"sync b{j}", _CAT_SYNC, _HOST_TRACK, batch=j):
            got = to_host(value)
        if clock is not None:
            clock.resolve(j)
        return got

    results: List[Any] = []
    pending: Optional[Tuple[Any, int]] = None
    for j, staged in enumerate(prefetch(batches, stage_fn, depth)):
        sp = (tracer.begin(f"b{j}", _CAT_DISPATCH, 1, batch=j)
              if tracer else None)
        start = None
        if clock is not None:
            if isinstance(staged, Staged):
                staged.shards()  # the stream waits for the copy first
            start = clock.mark()
        out = compute_fn(staged)
        if reduce_fn is not None:
            out = reduce_fn(out)
        if sp is not None:
            if clock is not None:
                clock.close(j, start, (sp,))
            tracer.end(sp)
        if not defer_sync:
            results.append(sync_get(out, j))
            continue
        if pending is not None:
            results.append(sync_get(*pending))
        pending = (out, j)
    if pending is not None:
        results.append(sync_get(*pending))
    return results


def stage_skews(depths: Sequence[int]) -> List[int]:
    """How many batches each stage lags behind stage 0.

    ``depths[0]`` is the host staging depth (it skews nothing -- staging
    runs *ahead*); ``depths[i>0]`` is the dispatch-ring depth between
    stage i-1 and stage i, i.e. how many batches of the inter-stage
    stream may be in flight before stage i consumes the oldest.  Skews
    accumulate: with per-ring depth 1 on a 3-stage chain, stage 2 works
    on batch k-2 while stage 0 works on batch k.
    """
    skews = [0] * len(depths)
    for i in range(1, len(depths)):
        skews[i] = skews[i - 1] + depths[i]
    return skews


def run_stage_pipelined(
    stage_fns: Sequence[Callable[[Any, Any], Any]],
    batches: Iterable[Any],
    *,
    stage_fn: Callable[[Any], Any] = lambda x: x,
    depths: Union[int, Sequence[int]] = 1,
    reduce_fn: Optional[Callable[[Any], Any]] = None,
    defer_sync: Optional[bool] = None,
    place_fns: Optional[Sequence[Optional[Callable[[Any, Any],
                                                   Any]]]] = None,
    tracer=None,
    monitor=None,
    stage_names: Optional[Sequence[str]] = None,
    metrics=None,
    metrics_labels: Optional[Dict[str, str]] = None,
    device=None,
) -> List[Any]:
    """Run every batch through a chain of stages, cross-batch pipelined.

    Each ``stage_fns[i]`` is called as ``fn(staged, carry)`` where
    ``staged`` is the batch's staged host input and ``carry`` is the
    value returned by stage i-1 for the same batch (``None`` for stage
    0); its return value is handed to stage i+1 *on device* -- the
    device-resident inter-stage stream.  The last stage's carry is
    realized (via ``reduce_fn``, then ``.cpu()``) and the per-batch
    results are returned in batch order.

    ``depths`` is one dispatch-ring depth per stage (an int applies
    chain-wide): ``depths[0]`` stages host batches ahead exactly like
    :func:`run_pipelined`; ``depths[i>0]`` lets stage i run that many
    batches behind stage i-1, so with any positive inter-stage depth the
    dispatch order interleaves stage i of batch k with stage i+1 of
    batch k-1 (software pipelining).  All inter-stage depths 0 degrades
    to the back-to-back schedule of :func:`run_pipelined`.

    Every batch still passes through every stage exactly once with
    identical inputs, so results are bitwise-equal to the serial
    schedule -- only the dispatch interleaving changes.

    ``place_fns`` is the multi-device hook: ``place_fns[i](staged,
    carry)`` runs right before stage i consumes a batch and returns the
    ``(staged, carry)`` pair moved onto stage i's device group (e.g.
    :func:`reshard` of the device-resident handoff onto the consumer's
    slots).  ``None`` entries (or ``place_fns=None``) leave the record
    untouched -- the single-group path.

    ``tracer`` (``repro_torch.trace.Tracer``; None/NULL = off) gives each
    stage its own track: every (stage, batch) dispatch becomes a *slot*
    span carrying ``stage``/``batch``/``tick`` args, with the reshard
    handoff and the stage-fn dispatch as its children; host staging and
    retire syncs land on the host track.  On one CUDA card (``device``:
    the card, or the pool of slots on it) the slot, handoff and dispatch
    spans carry the device's times (see the module docstring).
    ``monitor`` (a ``runtime.StepMonitor``) is fed the wall time between
    consecutive batch retirements; flagged steps annotate the retire's
    sync span with ``straggler=True``.  ``metrics`` (a
    ``repro_torch.metrics`` registry; None/NULL = off) records per-stage
    dispatch and reshard time histograms (host clock: the launch, on the
    card), stall counters and a tick histogram, labeled with
    ``metrics_labels``.  All only observe -- per-batch results are
    identical with or without them.
    """
    driver = StagePipelineDriver(
        stage_fns, stage_fn=stage_fn, depths=depths, reduce_fn=reduce_fn,
        defer_sync=defer_sync, place_fns=place_fns, tracer=tracer,
        monitor=monitor,
        stage_names=stage_names, metrics=metrics,
        metrics_labels=metrics_labels, device=device,
    )
    it = iter(batches)
    while True:
        while driver.wants_input:
            try:
                driver.feed(next(it))
            except StopIteration:
                driver.close()
                break
        if driver.idle:
            break
        driver.tick()
    return [v for _, v in driver.take()]


class _Poison:
    """A captured per-batch failure riding the carry slot: downstream
    stages skip the batch and retire delivers the error in its place."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException) -> None:
        self.error = error


class StagePipelineDriver:
    """The skewed dispatch ring of :func:`run_stage_pipelined` as a
    reentrant feed/tick state machine.

    Each fed batch remembers the tick it *entered* the ring, and stage
    ``i`` dispatches batch ``k`` once (a) stage ``i-1`` has finished it
    and (b) ``skews[i]`` ticks have passed since entry -- so a ring that
    went idle resumes with the same per-stage skew for the batches that
    follow, no global restart.  A long-running caller (the
    ``repro_torch.serve`` engine) interleaves :meth:`feed` and
    :meth:`tick` as admission waves arrive.

    ``capture_errors=True`` turns the batch-job raise-through into
    per-batch delivery: a host-side failure while staging, dispatching
    or reducing a batch (a refused tile, a shape error, an injected
    fault) poisons that batch's record, downstream stages skip it, and
    :meth:`take` yields ``(k, exception)`` for it -- the ring itself
    never wedges.  A fault on the card is different: it is sticky, every
    later CUDA call of the process fails with it, so no batch after it
    can be right.  On a CUDA ``device`` the driver therefore synchronises
    once after each captured failure and lets a device fault propagate,
    and the retire sync (``.cpu()``, where an asynchronous device fault
    surfaces) is never captured.  The default (``False``) propagates
    everything, exactly like the batch driver.

    ``place_fns`` is :func:`run_stage_pipelined`'s multi-device hook;
    ``tracer``, ``monitor``, ``stage_names``, ``metrics`` and
    ``metrics_labels`` are its observers; ``device`` is where the stages
    run, one device or the pool's slots (CUDA event timing of traced
    spans on one card; every card of the pool is synchronised after a
    captured failure).
    """

    def __init__(
        self,
        stage_fns: Sequence[Callable[[Any, Any], Any]],
        *,
        stage_fn: Callable[[Any], Any] = lambda x: x,
        depths: Union[int, Sequence[int]] = 1,
        reduce_fn: Optional[Callable[[Any], Any]] = None,
        defer_sync: Optional[bool] = None,
        place_fns: Optional[Sequence[Optional[Callable[[Any, Any],
                                                       Any]]]] = None,
        tracer=None,
        monitor=None,
        stage_names: Optional[Sequence[str]] = None,
        capture_errors: bool = False,
        metrics=None,
        metrics_labels: Optional[Dict[str, str]] = None,
        device=None,
    ) -> None:
        stage_fns = list(stage_fns)
        n_stages = len(stage_fns)
        if n_stages == 0:
            raise ValueError("need at least one stage")
        if place_fns is not None and len(place_fns) != n_stages:
            raise ValueError(
                f"need {n_stages} place fns, got {len(place_fns)}"
            )
        if isinstance(depths, int):
            depths = [depths] * n_stages
        else:
            depths = list(depths)
        if len(depths) != n_stages:
            raise ValueError(
                f"need {n_stages} stage depths, got {len(depths)}"
            )
        if any(d < 0 for d in depths):
            raise ValueError(f"stage depths must be >= 0, got {depths}")
        if defer_sync is None:
            defer_sync = any(d > 0 for d in depths)
        names = (list(stage_names) if stage_names
                 else [f"stage{i}" for i in range(n_stages)])
        if len(names) != n_stages:
            raise ValueError(
                f"need {n_stages} stage names, got {len(names)}"
            )
        if tracer:
            tracer.name_track(_HOST_TRACK, "host")
            for i, nm in enumerate(names):
                tracer.name_track(1 + i, nm)
            stage_fn = _traced_stage_fn(stage_fn, tracer)
        self.stage_fns = stage_fns
        self.stage_fn = stage_fn
        self.depths = depths
        self.skews = stage_skews(depths)
        self.reduce_fn = reduce_fn
        self.defer_sync = defer_sync
        self.place_fns = place_fns
        self.tracer = tracer
        self.monitor = monitor
        self.names = names
        self.capture_errors = capture_errors
        #: where the stages run: one device or the pool's slots
        self.device = device
        self._clock = _device_clock(tracer, device)
        # -- always-on metrics (duck-typed like the tracer: this module
        # never imports repro_torch.metrics; a falsy registry -- None or
        # NULL_REGISTRY -- costs one check here and nothing per tick) ----
        self._m_tick = self._m_dispatch = self._m_stall = None
        self._m_handoff = None
        if metrics:
            lab = dict(metrics_labels or {})
            self._m_tick = metrics.histogram(
                "pipeline_tick_seconds",
                "One driver tick: enter/dispatch-all-stages/retire.", **lab)
            self._m_dispatch = [
                metrics.histogram(
                    "pipeline_stage_dispatch_seconds",
                    "One (stage, batch) dispatch slot, handoff included.",
                    stage=nm, **lab)
                for nm in names
            ]
            self._m_handoff = [
                metrics.histogram(
                    "pipeline_stage_handoff_seconds",
                    "Cross-group reshard of the HBM-resident handoff.",
                    stage=nm, **lab)
                for nm in names
            ]
            self._m_stall = [
                {
                    reason: metrics.counter(
                        "pipeline_stall_total",
                        "Skipped stage dispatches by cause: ring skew "
                        "not yet satisfied, or producer stage behind.",
                        stage=nm, reason=reason, **lab)
                    for reason in ("skew", "producer")
                }
                for nm in names
            ]
        # -- ring state ------------------------------------------------------
        self._staged: deque = deque()       # staged, not yet entered
        #: batch k -> [staged, carry]; held from entry until retire (the
        #: window the planner prices as ring replicas)
        self._records: Dict[int, List[Any]] = {}
        self._entry_tick: Dict[int, int] = {}
        self._done = [0] * n_stages         # next batch stage i dispatches
        self._retire_next = 0
        self._entered = 0                   # batches entered into the ring
        self._accepted = 0                  # batches fed (entered + staged)
        self._t = 0
        self._pending: deque = deque()      # deferred (value, k) syncs
        self._out: deque = deque()          # retired (k, result) in order
        self._closed = False
        self._last_retire = (
            [time.perf_counter()] if monitor is not None else None
        )

    # -- feeding -------------------------------------------------------------
    @property
    def wants_input(self) -> bool:
        """True while the host staging window (``depths[0]`` ahead plus
        the one entering this tick) has room and the source isn't closed."""
        return not self._closed and len(self._staged) <= self.depths[0]

    @property
    def in_flight(self) -> int:
        """Batches accepted but not yet delivered through :meth:`take`."""
        return (len(self._staged) + len(self._records)
                + len(self._pending) + len(self._out))

    @property
    def accepted(self) -> int:
        """Total batches fed so far (the next :meth:`feed`'s index)."""
        return self._accepted

    @property
    def idle(self) -> bool:
        """True when nothing is staged, in the ring, or pending sync."""
        return not (self._staged or self._records or self._pending)

    def feed(self, item: Any) -> int:
        """Stage one batch into the ring; returns its batch index."""
        if self._closed:
            raise RuntimeError("driver is closed")
        k = self._accepted
        try:
            self._staged.append(self.stage_fn(item))
        except Exception as e:
            if not self._keeps():
                raise
            self._staged.append(_Poison(e))
        self._accepted += 1
        return k

    def close(self) -> None:
        """No more batches will be fed; remaining ticks drain the ring."""
        self._closed = True

    def _keeps(self) -> bool:
        """Whether a host-side failure just caught is kept for its batch:
        only under ``capture_errors``, and on a card only while the card
        reports no fault (a sticky fault raises from the synchronise)."""
        if not self.capture_errors:
            return False
        for dev in _physical(self.device):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return True

    # -- the tick ------------------------------------------------------------
    def tick(self) -> bool:
        """Advance the ring one tick: enter at most one staged batch,
        give every stage its one skew-scheduled dispatch, retire at most
        one finished batch.  Returns False once nothing progressed (ring
        dry -- feed more or stop)."""
        tick_t0 = time.perf_counter() if self._m_tick is not None else 0.0
        progressed = False
        if self._staged:
            k = self._entered
            staged = self._staged.popleft()
            if isinstance(staged, _Poison):
                self._records[k] = [None, staged]
            else:
                self._records[k] = [staged, None]
            self._entry_tick[k] = self._t
            self._entered += 1
            progressed = True
        t = self._t
        for i, fn in enumerate(self.stage_fns):
            k = self._done[i]
            if k not in self._records or k >= self._entered:
                continue
            if t - self._entry_tick[k] < self.skews[i]:
                if self._m_stall is not None:
                    self._m_stall[i]["skew"].inc()
                continue  # ring depth: stage i lags entry by skews[i]
            if i > 0 and self._done[i - 1] <= k:
                if self._m_stall is not None:
                    self._m_stall[i]["producer"].inc()
                continue  # producer stage hasn't finished this batch
            self._done[i] = k + 1
            progressed = True
            rec = self._records[k]
            if isinstance(rec[1], _Poison):
                continue  # upstream failure: skip, deliver at retire
            slot_t0 = (time.perf_counter()
                       if self._m_dispatch is not None else 0.0)
            self._dispatch(i, fn, rec, k, t)
            if self._m_dispatch is not None:
                self._m_dispatch[i].observe(time.perf_counter() - slot_t0)
        k = self._retire_next
        if k in self._records and self._done[-1] > k:
            rec = self._records.pop(k)
            del self._entry_tick[k]
            self._retire_next += 1
            self._retire(rec[1], k)
            progressed = True
        if not self._records and not self._staged:
            while self._pending:
                self._flush_one()
        self._t += 1
        if self._m_tick is not None:
            self._m_tick.observe(time.perf_counter() - tick_t0)
        return progressed

    def _dispatch(self, i: int, fn, rec: List[Any], k: int, t: int) -> None:
        """Stage ``i`` of batch ``k``: ``rec[1]`` becomes its carry (or a
        :class:`_Poison` with the failure under ``capture_errors``)."""
        place = self.place_fns[i] if self.place_fns is not None else None
        tracer = self.tracer
        if not tracer:
            try:
                if place is not None:
                    self._place(i, place, rec)
                rec[1] = fn(rec[0], rec[1])
            except Exception as e:
                if not self._keeps():
                    raise
                rec[1] = _Poison(e)
            return
        clock = self._clock
        slot = tracer.begin(f"b{k}", _CAT_SLOT, 1 + i, stage=i, batch=k,
                            tick=t)
        start = mid = None
        if clock is not None:
            if isinstance(rec[0], Staged):
                # the stream waits for the batch's host copy before the
                # start event: a span holds the stage's own device work
                rec[0].shards()
            start = mid = clock.mark()
        disp = None
        try:
            if place is not None:
                hand = tracer.begin(f"reshard b{k}", _CAT_HANDOFF, 1 + i,
                                    stage=i, batch=k)
                try:
                    self._place(i, place, rec)
                finally:
                    tracer.end(hand)
                    if clock is not None:
                        mid = clock.mark()
                        clock.interval(k, start, mid, (hand,))
            disp = tracer.begin(self.names[i], _CAT_DISPATCH, 1 + i,
                                stage=i, batch=k)
            rec[1] = fn(rec[0], rec[1])
        except Exception as e:
            if not self._keeps():
                raise
            rec[1] = _Poison(e)
        finally:
            end = clock.mark() if clock is not None else None
            if disp is not None:
                tracer.end(disp)
                if clock is not None:
                    clock.interval(k, mid, end, (disp,))
            if clock is not None:
                clock.interval(k, start, end, (slot,))
            tracer.end(slot)

    def _place(self, i: int, place, rec: List[Any]) -> None:
        """Run stage ``i``'s place fn on the batch record, metered."""
        t0 = time.perf_counter() if self._m_handoff is not None else 0.0
        rec[0], rec[1] = place(rec[0], rec[1])
        if self._m_handoff is not None:
            self._m_handoff[i].observe(time.perf_counter() - t0)

    # -- retire / sync -------------------------------------------------------
    def _retire(self, carry: Any, k: int) -> None:
        if isinstance(carry, _Poison):
            self._deliver_error(carry.error, k)
            return
        try:
            value = (self.reduce_fn(carry)
                     if self.reduce_fn is not None else carry)
        except Exception as e:
            if not self._keeps():
                raise
            self._deliver_error(e, k)
            return
        if not self.defer_sync:
            self._deliver_sync(value, k)
            return
        self._pending.append((value, k))
        if len(self._pending) > 1:
            self._flush_one()

    def _flush_one(self) -> None:
        self._deliver_sync(*self._pending.popleft())

    def _deliver_error(self, error: BaseException, k: int) -> None:
        if self._clock is not None:
            self._clock.resolve(k)
        self._out.append((k, error))

    def _deliver_sync(self, value: Any, k: int) -> None:
        self._out.append((k, self._sync_get(value, k)))

    def _sync_get(self, value: Any, k: int) -> Any:
        tracer = self.tracer
        sp = (tracer.begin(f"sync b{k}", _CAT_SYNC, _HOST_TRACK, batch=k)
              if tracer else None)
        try:
            got = to_host(value)
        except Exception:
            if sp is not None:
                tracer.end(sp)  # the trace stays well formed
            raise
        if self.monitor is not None:
            now = time.perf_counter()
            flagged = self.monitor.record(now - self._last_retire[0])
            self._last_retire[0] = now
            if flagged and sp is not None:
                sp.args["straggler"] = True
        if sp is not None:
            tracer.end(sp)
        if self._clock is not None:
            self._clock.resolve(k)
        return got

    # -- results -------------------------------------------------------------
    def take(self) -> List[Tuple[int, Any]]:
        """Drain the delivered results: ``(batch index, realized value)``
        pairs in batch order (the value is the captured exception for a
        poisoned batch under ``capture_errors``)."""
        out = list(self._out)
        self._out.clear()
        return out
