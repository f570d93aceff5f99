"""Device-memory model: the HBM pseudo-channel abstraction (paper Fig. 14).

The paper's Olympus flow sizes every host<->accelerator stream against a
concrete memory architecture: 32 HBM2 pseudo-channels of 256 MB each on
the Alveo U280, a PCIe host link, and on-chip PLM (BRAM/URAM).  This
module is the portable version of that datasheet: a frozen
:class:`MemoryTarget` per device family, used by

  * ``memory.layout``   -- buffer placement / batch sizing (E),
  * ``memory.dse``      -- the design-space cost model,
  * ``analysis.roofline`` -- which imports its TPU constants from here so
    the planner and the roofline can never disagree on peak numbers.

Targets are plain data -- hypothetical machines are made with
:meth:`MemoryTarget.with_` (the DSE bandwidth sweeps do exactly that).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

#: The paper's pseudo-channel capacity (HBM2 on the Alveo U280).
PAPER_CHANNEL_BYTES = 256 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class MemoryTarget:
    """One accelerator's memory datasheet (per compute unit / chip)."""

    name: str
    peak_flops: float          # peak FLOP/s per CU (native matmul precision)
    hbm_bytes: int             # device memory capacity
    hbm_bw: float              # aggregate device-memory bandwidth, bytes/s
    n_channels: int            # pseudo-channels the capacity is split into
    host_link_bw: float        # host->device transfer bandwidth, bytes/s
    vmem_bytes: int            # on-chip scratch (PLM / VMEM) per CU
    ici_bw: float = 50e9       # inter-CU link bandwidth, bytes/s
    burst_bytes: int = 64      # transfer/pack quantum (AXI burst, TPU lane)
    usable_hbm_fraction: float = 0.9   # leave headroom for the runtime
    dispatch_overhead_s: float = 20e-6  # per-batch launch/sync cost

    @property
    def channel_bytes(self) -> int:
        """Capacity of one pseudo-channel (paper: 256 MB)."""
        return self.hbm_bytes // self.n_channels

    @property
    def channel_bw(self) -> float:
        """Bandwidth of one pseudo-channel."""
        return self.hbm_bw / self.n_channels

    @property
    def usable_hbm_bytes(self) -> int:
        """HBM capacity after the reserved fraction is held back."""
        return int(self.hbm_bytes * self.usable_hbm_fraction)

    def with_(self, **overrides) -> "MemoryTarget":
        """A modified copy -- the DSE's what-if machine generator."""
        return dataclasses.replace(self, **overrides)


#: The paper's board: Alveo U280, 8 GiB HBM2 in 32 x 256 MiB
#: pseudo-channels at 460 GB/s, PCIe gen3 x16 host link, ~43 MB PLM.
ALVEO_U280 = MemoryTarget(
    name="alveo-u280",
    peak_flops=0.6e12,
    hbm_bytes=8 * 2 ** 30,
    hbm_bw=460e9,
    n_channels=32,
    host_link_bw=15.75e9,
    vmem_bytes=43 * 2 ** 20,
    ici_bw=0.0,               # single-FPGA target
    burst_bytes=64,           # 512-bit AXI beat
    dispatch_overhead_s=50e-6,
)

#: TPU v5e chip -- the repo's production target.  819 GB/s HBM2e modeled
#: as 32 pseudo-channels (512 MiB each); 128 MiB VMEM (schedule.py keeps
#: half for double buffering); ICI at 50 GB/s per link.
TPU_V5E = MemoryTarget(
    name="tpu-v5e",
    peak_flops=197e12,        # bf16 MXU peak (roofline's PEAK_FLOPS_BF16)
    hbm_bytes=16 * 2 ** 30,
    hbm_bw=819e9,
    n_channels=32,
    host_link_bw=32e9,
    vmem_bytes=128 * 2 ** 20,
    ici_bw=50e9,
    burst_bytes=512,          # 128-lane f32 vector
    dispatch_overhead_s=20e-6,
)

#: The CPU container the tests run on: host RAM plays HBM, a memcpy
#: plays the host link.  Numbers are deliberately conservative.
CPU_HOST = MemoryTarget(
    name="cpu-host",
    peak_flops=50e9,
    hbm_bytes=4 * 2 ** 30,
    hbm_bw=20e9,
    n_channels=4,
    host_link_bw=12e9,
    vmem_bytes=16 * 2 ** 20,  # ~L3 slice
    ici_bw=5e9,
    burst_bytes=64,
    dispatch_overhead_s=200e-6,
)

#: NVIDIA H100 SXM5 80GB -- the port's card.  Every figure is from
#: NVIDIA's H100 Tensor Core GPU datasheet (SXM column) or the Hopper
#: architecture whitepaper, as noted per field.
H100_SXM = MemoryTarget(
    name="h100-sxm",
    # datasheet: FP32 67 TFLOP/s on the CUDA cores (the port runs f32
    # without TF32, so the tensor-core rates do not apply)
    peak_flops=67e12,
    # datasheet: 80 GB HBM3 (the card reports 80 GiB of capacity)
    hbm_bytes=80 * 2 ** 30,
    # datasheet: 3.35 TB/s memory bandwidth
    hbm_bw=3.35e12,
    # whitepaper: 5 active HBM3 stacks x 16 64-bit channels
    n_channels=80,
    # datasheet: PCIe Gen5 x16 at 128 GB/s, i.e. 64 GB/s each way
    host_link_bw=64e9,
    # whitepaper: 227 KB (232,448 B) of shared memory usable by one
    # thread block (the per-CTA counterpart of a TPU core's VMEM)
    vmem_bytes=232_448,
    # datasheet: NVLink 900 GB/s total, 450 GB/s each way
    ici_bw=450e9,
    # one 128-byte L2 cache line / global-memory transaction
    burst_bytes=128,
    dispatch_overhead_s=20e-6,
)

#: NVIDIA H100 SXM5 datasheet: dense BF16 on the tensor cores, 989
#: TFLOP/s (1,979 is with sparsity) -- the peak a model's bf16 products
#: are priced at (``analysis.roofline``, the chip smoke's bounds), where
#: ``H100_SXM.peak_flops`` is the CUDA cores' f32 rate the CFD plans use
H100_SXM_BF16_FLOPS = 989e12

TARGETS = {t.name: t for t in (ALVEO_U280, TPU_V5E, CPU_HOST, H100_SXM)}

#: datasheets of a card the port's CUDA kernels run on.  There a kernel
#: stage's block is the kernel's tile ``te`` (the elements a CTA takes a
#: step, legal from 1 to the kernel's largest) and the kernels walk a
#: ragged last tile, so E is not padded to it.  On every other datasheet
#: the block is the reference's VMEM block, a divisor of E that the
#: plan models and the CUDA kernels never launch with
#: (``memory.layout.kernel_tiles`` reads this set).
KERNEL_TILE_TARGETS = frozenset({H100_SXM.name})


class UnknownTargetError(ValueError):
    """A target name that matches no datasheet (after normalization)."""


def canonical_target_name(name: str) -> str:
    """One spelling per datasheet: case-insensitive, underscores and
    dashes interchangeable (CI passes ``alveo-u280``, the Python API
    historically used ``alveo_u280`` -- both must resolve)."""
    return str(name).strip().lower().replace("_", "-")


def resolve_target(target, device=None) -> MemoryTarget:
    """None -> detect (on ``device``); MemoryTarget -> itself; str -> datasheet lookup
    under :func:`canonical_target_name`.  Unknown names raise
    :class:`UnknownTargetError` listing every known target, with a
    did-you-mean suggestion for near misses (surfaced verbatim by the
    CLIs' error path, exit code 2)."""
    if target is None:
        return detect_target(device)
    if isinstance(target, MemoryTarget):
        return target
    key = canonical_target_name(target)
    if key not in TARGETS:
        import difflib

        close = difflib.get_close_matches(key, sorted(TARGETS), n=1)
        hint = f" -- did you mean {close[0]!r}?" if close else ""
        raise UnknownTargetError(
            f"unknown target {target!r}; known targets: "
            f"{', '.join(sorted(TARGETS))} (underscores and dashes are "
            f"interchangeable){hint}"
        )
    return TARGETS[key]


def resolve_device(device=None):
    """The device an entry point runs on: ``None`` means the CUDA card,
    and raises when there is none -- the CPU is used only when asked for
    explicitly (``device="cpu"``), never as a silent fallback."""
    import torch

    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "the plain PyTorch paths on the host"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_devices(devices=None, device=None):
    """The device pool an entry point runs on: the ordered list of slots
    it shards the element axis over -- the port's counterpart of the
    reference's element mesh (``mesh=``).

    ``devices`` lists the slots (torch devices or their names); an entry
    may repeat, as the reference's forced host devices are several
    devices on one CPU, so ``["cpu", "cpu"]`` is a two-slot pool on the
    host and ``["cuda:0", "cuda:0"]`` one on a single card.  ``device``
    is the one-slot shorthand.  With neither, the pool is every visible
    CUDA card, as the reference's mesh defaults to ``jax.devices()``; it
    raises when there is none (never a silent fallback to the CPU)."""
    import torch

    if devices is not None and device is not None:
        raise ValueError("pass a pool (devices=) or one device (device=), "
                         "not both")
    if device is not None:
        return [resolve_device(device)]
    if devices is None:
        resolve_device(None)  # raises without a card
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    pool = [resolve_device(d) for d in devices]
    if not pool:
        raise ValueError("a device pool needs at least one slot")
    return pool


def detect_target(device=None) -> MemoryTarget:
    """The datasheet of the device an entry point runs on.

    ``device="cpu"`` selects :data:`CPU_HOST`; otherwise the CUDA card's
    name is read, and an H100 selects :data:`H100_SXM`.  Any other card
    raises :class:`UnknownTargetError` -- its numbers are not guessed."""
    import torch

    device = resolve_device(device)
    if device.type == "cpu":
        return CPU_HOST
    if device.type != "cuda":
        raise UnknownTargetError(f"no memory datasheet for device {device}")
    name = torch.cuda.get_device_properties(device).name
    if "H100" in name:
        return H100_SXM
    raise UnknownTargetError(
        f"no memory datasheet for CUDA device {name!r}; known cards: "
        "NVIDIA H100 (pass target= to plan for another datasheet)"
    )


def pad_to_burst(nbytes: int, target: MemoryTarget) -> int:
    """Round a record up to the target's transfer quantum (the paper
    packs p^3 scalars into 256-bit HBM words; the remainder is padding)."""
    q = target.burst_bytes
    return ((nbytes + q - 1) // q) * q


def channels_for(nbytes: int, target: MemoryTarget) -> int:
    """Pseudo-channels needed to hold ``nbytes`` (>= 1)."""
    cb = target.channel_bytes
    return max(1, -(-nbytes // cb))
