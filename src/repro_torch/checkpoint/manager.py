"""Atomic, async checkpointing of nested dicts of tensors (no external
deps), in the reference's layout (``repro/checkpoint/manager.py``):

Layout:  <dir>/step_<N>/   one .npy per leaf
                           manifest.json  (names, files, shapes, dtypes, step)
         <dir>/LATEST      -> step_<N>    (atomic rename + pointer swap)

A leaf's name is its path in the tree, keys joined by dots (list items
by their index), as the reference names it.  numpy has no bfloat16 of
its own, so a bfloat16 leaf is written as its raw 16 bits (``uint16``)
with ``"dtype": "bfloat16"`` in the manifest, as the reference's
manifest records it; on reading, a 2-byte array (``uint16``, or the
``|V2`` that a reference bfloat16 leaf loads as without ``ml_dtypes``)
restored into a bfloat16 leaf is taken as its bits.  So the port
restores the reference's checkpoints, and its own.

Fault-tolerance contract:
  * a checkpoint directory becomes visible only after all leaves and the
    manifest are fully written (write to ``.tmp`` then ``os.rename``);
  * LATEST is updated last, so a crash mid-save leaves the previous
    checkpoint intact;
  * ``save(..., blocking=False)`` copies the state to the host first,
    then hands the writes to a thread (training continues; ``wait()``
    joins before exit);
  * ``restore()`` places the leaves on ``device`` (default: each leaf of
    ``like``'s device).

A sharded state (DTensor leaves, :mod:`repro_torch.distributed`) is
saved whole, in the same format: every rank gathers each leaf
(``full_tensor()``), rank 0 writes, and every rank waits on a barrier.
Restored into a ``like`` of DTensors, each leaf is placed back by its
placements, so a checkpoint of a sharded run restores into an unsharded
state and back.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..tree import named_leaves, tree_unflatten


def _to_host(t) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array to write and the dtype name to record."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", copy=True)  # a copy even of a host tensor
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(t)
    return arr, str(arr.dtype)


class CheckpointManager:
    """Checkpoints under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str, *, keep: int = 3) -> None:
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, state: Any, *, step: int, blocking: bool = True) -> None:
        """Write ``state`` as step ``step`` (by a thread unless blocking).
        Of a sharded state, every rank must call it; rank 0 writes."""
        leaves = named_leaves(state)
        if any(isinstance(v, DTensor) for _, v in leaves):
            self._save_sharded(leaves, step)
            return
        # copy to the host first, so later in-place updates cannot reach
        # the checkpoint
        host = [(name, *_to_host(v)) for name, v in leaves]
        if blocking:
            self._write(host, step)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(host, step), daemon=True
            )
            self._thread.start()

    def _save_sharded(self, leaves, step: int) -> None:
        """Gather each DTensor leaf whole on every rank (a collective),
        write on rank 0, then a barrier; blocking."""
        host = []
        for name, v in leaves:
            if isinstance(v, DTensor):
                v = v.full_tensor()
            host.append((name, *_to_host(v)))
        if dist.get_rank() == 0:
            self._write(host, step)
        dist.barrier()

    def wait(self) -> None:
        """Join the writer of the last non-blocking save."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, host, step: int) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for name, arr, dtype in host:
            fname = name.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"name": name, "file": fname, "shape": list(arr.shape),
                 "dtype": dtype}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # pointer swap (atomic on POSIX)
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(
            d for d in os.listdir(self.dir) if d.startswith("step_")
            and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        """The step ``LATEST`` names, or None before the first save."""
        latest = os.path.join(self.dir, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            name = f.read().strip()
        return int(name.split("_")[1])

    def restore(self, like: Any, *, step: Optional[int] = None,
                device=None) -> Any:
        """Restore into the structure, shapes and dtypes of ``like`` (a tree
        of tensors, meta tensors included); leaves go to ``device``, else
        to the device of ``like``'s leaf (the CPU for a meta leaf).  A
        DTensor leaf of ``like`` comes back a DTensor of its mesh and
        placements (every rank reads the whole leaf and keeps its shard)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.dir}")
        cdir = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {l["name"]: l for l in manifest["leaves"]}
        out = []
        for name, leaf in named_leaves(like):
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            arr = np.load(os.path.join(cdir, by_name[name]["file"]))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {arr.shape} != {tuple(leaf.shape)}"
                )
            dev = device
            if dev is None:
                dev = leaf.device if leaf.device.type != "meta" else "cpu"
            t = self._tensor(arr, leaf.dtype, name).to(dev)
            if isinstance(leaf, DTensor):
                from ..distributed.sharding import distribute

                t = distribute(t, leaf.device_mesh, leaf.placements)
            out.append(t)
        return tree_unflatten(like, out)

    @staticmethod
    def _tensor(arr: np.ndarray, dtype: torch.dtype, name: str):
        if dtype == torch.bfloat16:
            if arr.dtype.itemsize != 2:
                raise ValueError(f"{name}: {arr.dtype} leaf for a bfloat16 one")
            bits = np.ascontiguousarray(arr).view(np.int16)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(dtype)
