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

Tracing, metrics, straggler monitoring, per-batch error capture and the
multi-device ``place_fns`` hook of the reference are not ported yet.
"""
from __future__ import annotations

from collections import deque
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch


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
    """One staged batch: device tensors by name, plus the event their
    host->device copy records (None on the CPU).  :meth:`arrays` makes the
    caller's current stream wait for that copy before handing them out."""

    __slots__ = ("_arrays", "_ready")

    def __init__(self, arrays: Dict[str, torch.Tensor],
                 ready: Optional[torch.cuda.Event] = None) -> None:
        self._arrays = arrays
        self._ready = ready

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The device tensors, once the current stream waits for their copy."""
        if self._ready is not None:
            device = next(iter(self._arrays.values())).device
            torch.cuda.current_stream(device).wait_event(self._ready)
        return self._arrays


class HostStager:
    """Host batches (dicts of numpy arrays) to device tensors.

    On a CUDA device each batch is copied into one slot of a ring of
    pinned host buffers, then to freshly allocated device tensors with a
    ``non_blocking`` copy on a side stream; the copy's event is recorded
    so the consumer's stream waits for it (:meth:`Staged.arrays`).  A
    pinned slot is refilled only after its previous copy's event has
    completed, and each device tensor is marked as used by the compute
    stream (``record_stream``) so the caching allocator never hands its
    memory out while a kernel may still read it.  On the CPU a batch
    becomes tensors that share the numpy arrays' memory.
    """

    def __init__(self, device, slots: int = 2) -> None:
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._slots: List[Optional[Tuple[Dict[str, torch.Tensor],
                                         torch.cuda.Event]]] = (
            [None] * max(1, slots)
        )
        self._next = 0
        self.copy_stream = torch.cuda.Stream(self.device) if self._cuda else None

    def __call__(self, batch: Dict[str, np.ndarray]) -> Staged:
        if not self._cuda:
            return Staged({
                k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()
            })
        j = self._next
        self._next = (j + 1) % len(self._slots)
        held = self._slots[j]
        pinned: Dict[str, torch.Tensor] = {}
        if held is not None:
            held[1].synchronize()  # the slot's last copy has left the host
            pinned = held[0]
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        for k, h in host.items():
            buf = pinned.get(k)
            if buf is None or buf.shape != h.shape or buf.dtype != h.dtype:
                pinned[k] = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
            pinned[k].copy_(h)
        compute = torch.cuda.current_stream(self.device)
        dev: Dict[str, torch.Tensor] = {}
        with torch.cuda.stream(self.copy_stream):
            for k, buf in pinned.items():
                if k not in host:
                    continue
                d = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
                d.copy_(buf, non_blocking=True)
                d.record_stream(compute)
                dev[k] = d
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        self._slots[j] = (pinned, ready)
        return Staged(dev, ready)


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


def run_pipelined(
    compute_fn: Callable[[Any], Any],
    batches: Iterable[Any],
    *,
    stage_fn: Callable[[Any], Any] = lambda x: x,
    depth: int = 1,
    reduce_fn: Optional[Callable[[Any], Any]] = None,
    defer_sync: Optional[bool] = None,
) -> List[Any]:
    """Run every batch through ``compute_fn`` with K-deep staging.

    Returns the realized (host-side) per-batch results, in order.

    ``reduce_fn`` maps a device result to the (small) value to realize --
    e.g. a checksum scalar -- so full batches never transfer back.
    ``defer_sync`` delays each host sync by one batch so compute k+1 is
    enqueued before blocking on k (defaults to on whenever ``depth > 0``;
    forcing it off gives the paper's serial baseline).
    """
    if defer_sync is None:
        defer_sync = depth > 0
    results: List[Any] = []
    pending = None
    for staged in prefetch(batches, stage_fn, depth):
        out = compute_fn(staged)
        if reduce_fn is not None:
            out = reduce_fn(out)
        if not defer_sync:
            results.append(to_host(out))
            continue
        if pending is not None:
            results.append(to_host(pending))
        pending = out
    if pending is not None:
        results.append(to_host(pending))
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
    """
    driver = StagePipelineDriver(
        stage_fns, stage_fn=stage_fn, depths=depths, reduce_fn=reduce_fn,
        defer_sync=defer_sync,
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


class StagePipelineDriver:
    """The skewed dispatch ring of :func:`run_stage_pipelined` as a
    reentrant feed/tick state machine.

    Each fed batch remembers the tick it *entered* the ring, and stage
    ``i`` dispatches batch ``k`` once (a) stage ``i-1`` has finished it
    and (b) ``skews[i]`` ticks have passed since entry -- so a ring that
    went idle resumes with the same per-stage skew for the batches that
    follow, no global restart.  Failures propagate to the caller.
    """

    def __init__(
        self,
        stage_fns: Sequence[Callable[[Any, Any], Any]],
        *,
        stage_fn: Callable[[Any], Any] = lambda x: x,
        depths: Union[int, Sequence[int]] = 1,
        reduce_fn: Optional[Callable[[Any], Any]] = None,
        defer_sync: Optional[bool] = None,
    ) -> None:
        stage_fns = list(stage_fns)
        n_stages = len(stage_fns)
        if n_stages == 0:
            raise ValueError("need at least one stage")
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
        self.stage_fns = stage_fns
        self.stage_fn = stage_fn
        self.depths = depths
        self.skews = stage_skews(depths)
        self.reduce_fn = reduce_fn
        self.defer_sync = defer_sync
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
        self._staged.append(self.stage_fn(item))
        self._accepted += 1
        return k

    def close(self) -> None:
        """No more batches will be fed; remaining ticks drain the ring."""
        self._closed = True

    # -- the tick ------------------------------------------------------------
    def tick(self) -> bool:
        """Advance the ring one tick: enter at most one staged batch,
        give every stage its one skew-scheduled dispatch, retire at most
        one finished batch.  Returns False once nothing progressed (ring
        dry -- feed more or stop)."""
        progressed = False
        if self._staged:
            k = self._entered
            self._records[k] = [self._staged.popleft(), None]
            self._entry_tick[k] = self._t
            self._entered += 1
            progressed = True
        t = self._t
        for i, fn in enumerate(self.stage_fns):
            k = self._done[i]
            if k not in self._records or k >= self._entered:
                continue
            if t - self._entry_tick[k] < self.skews[i]:
                continue  # ring depth: stage i lags entry by skews[i]
            if i > 0 and self._done[i - 1] <= k:
                continue  # producer stage hasn't finished this batch
            self._done[i] = k + 1
            progressed = True
            rec = self._records[k]
            rec[1] = fn(rec[0], rec[1])
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
        return progressed

    # -- retire / sync -------------------------------------------------------
    def _retire(self, carry: Any, k: int) -> None:
        value = self.reduce_fn(carry) if self.reduce_fn is not None else carry
        if not self.defer_sync:
            self._out.append((k, to_host(value)))
            return
        self._pending.append((value, k))
        if len(self._pending) > 1:
            self._flush_one()

    def _flush_one(self) -> None:
        value, k = self._pending.popleft()
        self._out.append((k, to_host(value)))

    # -- results -------------------------------------------------------------
    def take(self) -> List[Tuple[int, Any]]:
        """Drain the delivered results: ``(batch index, realized value)``
        pairs in batch order."""
        out = list(self._out)
        self._out.clear()
        return out
