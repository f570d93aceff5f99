"""Scalar-type policies (the `base2` dialect analogue) on torch dtypes.

The paper treats the scalar representation as a compiler knob: double,
then fixed-point ap_fixed<64,24> (Q24.40) and ap_fixed<32,8> (Q8.24).
This module carries the float ladder (f64/f32/bf16).  bf16 stores in
bfloat16 and accumulates every contraction in float32, as the reference
policy does.

The fixed-point policies are not ported yet: their 64-bit multiply
shifts unsigned 64-bit limbs, and torch has no ``>>`` on uint64, so
they need a signed-limb rewrite that stays bit-exact against the
reference.  Asking for one by name raises :class:`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class FloatPolicy:
    """Plain float computation at a given dtype."""

    dtype: str = "float32"  # float64 | float32 | bfloat16
    accum_dtype: Optional[str] = None  # einsum accumulation type

    @property
    def name(self) -> str:
        return self.dtype

    @property
    def is_fixed_point(self) -> bool:
        return False

    @property
    def torch_dtype(self) -> torch.dtype:
        """The storage dtype as a torch dtype."""
        return getattr(torch, self.dtype)

    @property
    def torch_accum_dtype(self) -> torch.dtype:
        """The dtype contractions accumulate in."""
        return getattr(torch, self.accum_dtype or self.dtype)

    @property
    def bits(self) -> int:
        return self.torch_dtype.itemsize * 8


Policy = FloatPolicy

F64 = FloatPolicy("float64")
F32 = FloatPolicy("float32")
BF16 = FloatPolicy("bfloat16", accum_dtype="float32")

POLICIES = {p.name: p for p in (F64, F32, BF16)}

#: The paper's fixed-point formats (reference names), not ported yet.
FIXED_POINT_NAMES = ("fixed64_q24.40", "fixed32_q8.24")


def get_policy(name: str) -> FloatPolicy:
    """The policy registered under ``name``.

    Raises :class:`NotImplementedError` for the fixed-point formats and
    :class:`ValueError` for names no package knows."""
    if name in POLICIES:
        return POLICIES[name]
    if name in FIXED_POINT_NAMES:
        raise NotImplementedError(
            f"fixed-point policy {name!r} is not ported yet"
        )
    raise ValueError(f"unknown policy {name!r}; known: {sorted(POLICIES)}")


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in float32, like the reference's
    ``einsum(..., preferred_element_type=float32)`` on bfloat16 operands.

    ``b`` is 2-D, or has ``a``'s leading (batch) dims.  On a CUDA card,
    bfloat16/float16 operands go to ``torch.mm``/``torch.bmm`` with
    ``out_dtype=torch.float32`` (no rounding to the low precision), and
    any other shape raises.  On the CPU, which has no kernel for those
    overloads, and for float32 operands, both are upcast to float32,
    which is exact for bfloat16 values and accumulates in float32."""
    low = (torch.bfloat16, torch.float16)
    if a.device.type == "cuda" and (a.dtype in low or b.dtype in low):
        if a.dtype != b.dtype:
            raise TypeError(f"matmul_f32: operands of {a.dtype} and {b.dtype}")
        if b.dim() == 2:
            out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                           out_dtype=torch.float32)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        if b.dim() == a.dim() >= 3 and b.shape[:-2] == a.shape[:-2]:
            out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                            b.reshape(-1, *b.shape[-2:]),
                            out_dtype=torch.float32)
            return out.reshape(*a.shape[:-2], *out.shape[-2:])
        raise ValueError(
            f"matmul_f32: b {tuple(b.shape)} is neither 2-D nor batched "
            f"like a {tuple(a.shape)}"
        )
    return torch.matmul(a.float(), b.float())
