"""Device meshes, as the reference's ``repro/launch/mesh.py``.

Mesh axes:
  * ``pod``   -- DCN-class axis across pods (data parallel by default;
    the pipeline module can claim it for PP stages).
  * ``data``  -- data parallelism (batch / CFD elements).
  * ``model`` -- tensor parallelism (heads / ffn / vocab / experts).

:func:`make_local_mesh` builds a ``torch.distributed`` ``DeviceMesh``
over the ranks of the default process group (one process a device, as
``torch.distributed.run`` starts them), the port's counterpart of a
``jax.sharding.Mesh`` over ``jax.devices()``.  The production meshes
(256 and 512 devices) are returned as :class:`MeshShape`, axis names and
sizes only: the sharding rules read nothing else, and no one machine
holds that many ranks.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..memory.channels import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


Mesh = Union[DeviceMesh, MeshShape]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def launched() -> bool:
    """True under ``torch.distributed.run`` (its environment is set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(device) -> None:
    """Join the default process group if there is none: from the
    ``torch.distributed.run`` environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``...) when it is set, else a group of this one process
    over a ``FileStore`` in a fresh temporary directory.  ``nccl`` for a
    CUDA device, ``gloo`` otherwise."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if launched():
        dist.init_process_group(backend)
        return
    store = dist.FileStore(
        os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def make_local_mesh(model_axis: int = 1, device=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over every rank of the default process
    group, ``data = world_size // model_axis``; with no process group, a
    1 x 1 mesh of this process (see :func:`init_process_group`).
    ``device`` is this rank's device (default: the CUDA card)."""
    device = resolve_device(device)
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ["WORLD_SIZE"]) if launched() else 1
    if model_axis < 1 or world % model_axis:
        raise ValueError(
            f"model axis {model_axis} does not divide the world size "
            f"{world}; start a multiple of it with python -m "
            "torch.distributed.run --nproc-per-node N")
    init_process_group(device)
    return init_device_mesh(device.type, (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def axis_names(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in order."""
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """``{axis name: size}`` of either kind of mesh."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh: Mesh) -> tuple:
    """The axes a global batch dimension shards over."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
