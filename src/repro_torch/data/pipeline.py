"""Double-buffered host-to-device prefetch (the paper's ping/pong
channels, Fig. 14a, at the host-runtime level), as the reference's
``repro/data/pipeline.py``.

A background thread stages batch k+1 while step k computes; the queue
depth of 2 is the paper's even/odd channel pair.  On the card each
array of a batch is copied into pinned host memory and then to the
device with ``non_blocking`` on a side CUDA stream; an event recorded
after the copies is waited on by the consumer's stream when it takes the
batch (the reference's ``device_put``).  On the CPU the batch is a dict
of tensors.  ``state()`` exposes the source step counter for
checkpoint/resume.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import torch

from ..memory.channels import resolve_device


class PrefetchPipeline:
    """Batches of ``source`` (dicts of arrays) as dicts of tensors on
    ``device`` (default the CUDA card; ``device="cpu"`` on the host),
    ``depth`` batches ahead."""

    def __init__(
        self,
        source: Iterator[Dict[str, Any]],
        *,
        device=None,
        depth: int = 2,
    ) -> None:
        self.source = source
        self.device = resolve_device(device)
        self.depth = depth
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, batch: Dict[str, Any]):
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self._stream is None:
            return host, None
        pinned = {k: v.pin_memory() for k, v in host.items()}
        with torch.cuda.stream(self._stream):
            staged = {k: v.to(self.device, non_blocking=True)
                      for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        # the pinned buffers live until the copies have been waited on
        return staged, (event, pinned)

    def _worker(self) -> None:
        try:
            for batch in self.source:
                if self._stop.is_set():
                    return
                staged = self._stage(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on next __next__
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        staged, sync = item
        if sync is not None:
            event, _ = sync
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in staged.values():
                # allocated on the side stream, used on this one
                t.record_stream(current)
        return staged

    def state(self) -> Optional[Dict[str, int]]:
        """The source's resume state (its step counter), if it has one."""
        return self.source.state() if hasattr(self.source, "state") else None

    def close(self) -> None:
        """Stop the staging thread and drop the batches it queued."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
