"""Three-term roofline of a dry-run cell, as the reference's
``repro/analysis/roofline.py``, priced on the H100.

Terms (seconds), per device:

  compute    = device_FLOPs / peak_FLOP/s     (989 TF/s dense bf16 tensor cores)
  memory     = device_bytes / HBM_bw          (3.35 TB/s)
  collective = collective_bytes / link_bw     (450 GB/s NVLink, each way)

The constants are the H100 SXM datasheet's (``memory.channels``): the
tensor-core bf16 peak ``H100_SXM_BF16_FLOPS``, and ``H100_SXM``'s HBM and
NVLink rates -- one source with the memory planner, as the reference
shares ``TPU_V5E`` with its own.

The reference reads the terms from a compiled XLA executable.  The port
has none: :func:`analyze` takes the per-device counts the dry run
(``launch.dryrun``) records while one rank's step runs on ``meta``
tensors.  Collective bytes follow the reference's convention: the
RESULT buffer size of every all-reduce / all-gather / reduce-scatter /
all-to-all / collective-permute, a within-2x proxy for wire traffic,
used alike everywhere so iterations compare like against like.
:func:`collective_bytes` keeps the reference's parser of HLO text, for
programs that have one.

MODEL_FLOPS sanity: 6*N*D for dense training (N params, D tokens), 2*N*D
for inference; MoE uses active parameters.  The ratio MODEL_FLOPS /
(chips x device_FLOPs) flags remat/redundancy waste.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional

from ..memory.channels import H100_SXM as _H100, H100_SXM_BF16_FLOPS

PEAK_FLOPS_BF16 = H100_SXM_BF16_FLOPS  # per card
HBM_BW = _H100.hbm_bw                   # bytes/s per card
ICI_LINK_BW = _H100.ici_bw              # bytes/s per link, each way

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16,
}

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# result type on the LHS: %name = f32[128,256]{1,0} all-reduce(
_LINE_RE = re.compile(
    r"=\s*(?:\()?\s*([a-z0-9]+)\[([\d,]*)\][^=]*?\s"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)
# tuple-result collectives: (f32[8,128], f32[8,128]) all-to-all(...)
_TUPLE_RE = re.compile(
    r"=\s*\(([^)]*)\)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)
_TYPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")


def _type_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum collective result-buffer bytes per op kind (per device) in
    HLO text."""
    out: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for line in hlo_text.splitlines():
        if not any(c in line for c in COLLECTIVES):
            continue
        if "-done(" in line:
            continue  # async pair: count the -start only
        m = _TUPLE_RE.search(line)
        if m:
            types, kind = m.groups()
            for dtype, dims in _TYPE_RE.findall(types):
                out[kind] += _type_bytes(dtype, dims)
            continue
        m = _LINE_RE.search(line)
        if m:
            dtype, dims, kind = m.groups()
            out[kind] += _type_bytes(dtype, dims)
    return out


@dataclasses.dataclass
class RooflineReport:
    """One cell's per-device counts and their three terms (seconds)."""

    arch: str
    shape: str
    mesh: str
    chips: int
    device_flops: float
    device_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    bytes_per_device: int          # peak live memory (args+temps+outputs)
    model_flops: float             # analytic useful flops (global)

    @property
    def t_compute(self) -> float:
        """FLOPs at the bf16 tensor-core peak."""
        return self.device_flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        """Bytes at the HBM rate."""
        return self.device_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        """Collective bytes at one NVLink direction's rate."""
        return self.coll_bytes / ICI_LINK_BW

    @property
    def bottleneck(self) -> str:
        """The largest term's name."""
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS over the FLOPs of every chip."""
        total = self.device_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute-term share of the critical term: 1.0 means the program
        is exactly compute-bound with zero overhead above the tensor-core
        floor."""
        t_max = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t_max if t_max else 0.0

    def to_dict(self) -> dict:
        """The fields and the derived terms, for a JSON record."""
        d = dataclasses.asdict(self)
        d.update(
            t_compute=self.t_compute,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            bottleneck=self.bottleneck,
            useful_flops_ratio=self.useful_flops_ratio,
            roofline_fraction=self.roofline_fraction,
        )
        return d


def model_flops(
    *, params: int, tokens: int, kind: str, active_params: Optional[int] = None
) -> float:
    """6ND (train) / 2ND (inference) with MoE active-param correction."""
    n = active_params if active_params is not None else params
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def analyze(
    counts: Mapping,
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    model_flops_value: float,
    extra_flops: float = 0.0,
    extra_bytes: float = 0.0,
) -> RooflineReport:
    """The report of one cell from the dry run's per-device ``counts``:
    ``flops``, ``bytes``, ``collectives`` ({kind: result bytes}) and
    ``memory`` (``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``temp_size_in_bytes``), the reference's ``memory_analysis()``
    fields.  ``extra_flops``/``extra_bytes``: loop corrections from
    :mod:`.scancost`."""
    coll = {k: int(counts["collectives"].get(k, 0)) for k in COLLECTIVES}
    ma = counts["memory"]
    bytes_dev = (
        ma["argument_size_in_bytes"]
        + ma["output_size_in_bytes"]
        + ma["temp_size_in_bytes"]
    )
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        device_flops=float(counts["flops"]) + extra_flops,
        device_bytes=float(counts["bytes"]) + extra_bytes,
        coll_bytes=float(sum(coll.values())),
        coll_breakdown=coll,
        bytes_per_device=int(bytes_dev),
        model_flops=model_flops_value,
    )


def format_table(reports) -> str:
    """A fixed-width text table of reports."""
    hdr = (
        f"{'arch':<24} {'shape':<12} {'mesh':<10} {'t_comp(s)':>10} "
        f"{'t_mem(s)':>10} {'t_coll(s)':>10} {'bound':>10} {'useful':>7} "
        f"{'frac':>6} {'GB/dev':>7}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        lines.append(
            f"{r.arch:<24} {r.shape:<12} {r.mesh:<10} {r.t_compute:>10.4g} "
            f"{r.t_memory:>10.4g} {r.t_collective:>10.4g} {r.bottleneck:>10} "
            f"{r.useful_flops_ratio:>7.3f} {r.roofline_fraction:>6.3f} "
            f"{r.bytes_per_device/2**30:>7.2f}"
        )
    return "\n".join(lines)
