"""Scalar-type policies (the `base2` dialect analogue) on torch dtypes.

The paper treats the scalar representation as a compiler knob: double,
then fixed-point ap_fixed<64,24> (Q24.40) and ap_fixed<32,8> (Q8.24),
validated at MSE 9.39e-22 and 3.58e-12 on [-1, 1]-normalized CFD data.
This module carries the float ladder (f64/f32/bf16; bf16 stores in
bfloat16 and accumulates every contraction in float32, as the reference
policy does) and both Q-formats in torch integer arithmetic.

Fixed point is integer arithmetic, so every result equals the
reference's bit for bit: products round to nearest at the same bit,
sums wrap modulo the storage width exactly as XLA's do, and any order
or chunking of an integer sum gives the same bits.  As in the paper,
the conversion from/to double lives on the host side of the boundary
(``encode``/``decode``), and the compute graph stays in integer form.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
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


#: Values one fixed-point contraction broadcasts at once (one chunk),
#: and the slice an elementwise multiply or divide widens at once:
#: 2**24 int64 values are 128 MiB, and the limb arithmetic of a chunk
#: keeps about four such tensors alive.
CONTRACT_CHUNK_VALUES = 1 << 24


def _as_float64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def _split64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An int64 tensor as (high 32-bit limb, signed; low limb in
    [0, 2**32))."""
    return x >> 32, x & 0xFFFFFFFF


def _fmul64(a_limbs, b_limbs, f: int) -> torch.Tensor:
    """``a * b / 2**f`` of two int64 values from their limbs
    (:func:`_split64`), bit for bit the reference's 32/32 limb product:
    the low-limb product floored, the cross term rounded to nearest, so
    a result lies within [-1.5, +0.5] units of the exact product.

    The reference forms ``al * bl`` in uint64; it reaches
    2**64 - 2**33 + 1, past int64, and torch has no shift on uint64.  So
    ``bl`` is split into 16-bit halves: ``al * bl1 < 2**48`` and
    ``floor(al * bl / 2**f) = (al * bl1 + (al * bl0 >> 16)) >> (f - 16)``.
    No single product exceeds 2**63; the cross-term sum, the shifted high
    product and the final sum wrap modulo 2**64, as XLA's int64 does
    (exact while decoded magnitudes stay below 2**23 for Q24.40)."""
    if f <= 32:
        raise ValueError(f"the 64-bit multiply needs frac_bits > 32, got {f}")
    ah, al = a_limbs
    bh, bl = b_limbs
    lo = al * (bl & 0xFFFF)
    lo >>= 16
    lo += al * (bl >> 16)
    lo >>= f - 16
    cross = ah * bl
    cross += al * bh
    shift = f - 32
    cross += 1 << (shift - 1)
    cross >>= shift
    hi = ah * bh
    hi <<= 64 - f
    hi += cross
    hi += lo
    return hi


@dataclasses.dataclass(frozen=True)
class FixedPointPolicy:
    """Qm.n fixed point: ``total_bits`` storage with ``frac_bits`` fraction.

    The paper's formats:
      * fixed64 = Q24.40 -> FixedPointPolicy(64, 40)
      * fixed32 = Q8.24  -> FixedPointPolicy(32, 24)

    Values are assumed range-normalized (|x| bounded by the integer part),
    matching the paper's observation that the physical quantities can be
    rescaled into [-1, 1].
    """

    total_bits: int = 32
    frac_bits: int = 24

    def __post_init__(self) -> None:
        if self.total_bits not in (32, 64):
            raise ValueError("fixed point storage must be int32 or int64")
        if not 0 < self.frac_bits < self.total_bits:
            raise ValueError("frac_bits out of range")

    @property
    def name(self) -> str:
        m = self.total_bits - self.frac_bits
        return f"fixed{self.total_bits}_q{m}.{self.frac_bits}"

    @property
    def is_fixed_point(self) -> bool:
        return True

    @property
    def bits(self) -> int:
        return self.total_bits

    @property
    def storage_dtype(self) -> torch.dtype:
        return torch.int32 if self.total_bits == 32 else torch.int64

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    # -- host-side conversions (paper: done in host code, saves FPGA area) --
    def encode(self, x) -> torch.Tensor:
        """Round ``x * 2**frac_bits`` half to even (as ``jnp.round``)
        into the storage dtype; a tensor keeps its device, anything else
        becomes a CPU tensor.  Out-of-range values saturate and NaN
        becomes 0, as XLA's float-to-integer conversion does."""
        scaled = torch.round(_as_float64(x) * self.scale).nan_to_num(nan=0.0)
        top = 2.0 ** (self.total_bits - 1)
        q = scaled.clamp(-top, math.nextafter(top, 0.0)).to(self.storage_dtype)
        return q.masked_fill(scaled >= top, torch.iinfo(self.storage_dtype).max)

    def decode(self, q) -> torch.Tensor:
        return torch.as_tensor(q).to(torch.float64) / self.scale

    # -- device-side arithmetic ---------------------------------------------
    def fadd(self, a, b):
        return a + b

    def fsub(self, a, b):
        return a - b

    def _elementwise(self, fn, a, b):
        """``fn(a, b)`` over the broadcast of ``a`` and ``b``, in slices of
        dim 0 of at most :data:`CONTRACT_CHUNK_VALUES` values (never less
        than one row) written into one storage-dtype output, so an
        operand is widened a slice at a time, never whole.  Each output
        entry is computed alone, so the slicing never changes a bit."""
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return fn(a, b)
        a, b = torch.broadcast_tensors(a, b)
        if a.dim() == 0 or a.numel() <= CONTRACT_CHUNK_VALUES:
            return fn(a, b)
        out = torch.empty(a.shape, dtype=self.storage_dtype, device=a.device)
        step = max(1, CONTRACT_CHUNK_VALUES // (a.numel() // a.shape[0]))
        for i0 in range(0, a.shape[0], step):
            n = min(step, a.shape[0] - i0)
            out.narrow(0, i0, n).copy_(fn(a.narrow(0, i0, n),
                                          b.narrow(0, i0, n)))
        return out

    def fmul(self, a, b):
        """(a * b) >> frac_bits with a wide intermediate, round-to-nearest.

        int32 storage: exact via an int64 intermediate, wrapped back to
        int32.  int64 storage: the 128-bit product from limbs, see
        :func:`_fmul64`.  Widened in slices (:meth:`_elementwise`)."""
        f = self.frac_bits
        if self.total_bits == 32:
            def mul(x, y):
                wide = x.to(torch.int64) * y.to(torch.int64)
                wide += 1 << (f - 1)  # round to nearest
                wide >>= f
                return wide.to(torch.int32)
        else:
            def mul(x, y):
                return _fmul64(_split64(x), _split64(y), f)
        return self._elementwise(mul, a, b)

    def fdiv(self, a, b):
        """int32: ``(a << frac_bits) // b``, floor division as ``jnp``'s
        ``//``.  int64: through a float64 reciprocal of ``b`` (the
        reference's documented approximation), in its operation order.
        Widened in slices (:meth:`_elementwise`)."""
        if self.total_bits == 32:
            def div(x, y):
                wide = x.to(torch.int64) << self.frac_bits
                q = torch.div(wide, y.to(torch.int64), rounding_mode="floor")
                return q.to(torch.int32)
        else:
            def div(x, y):
                rec = 1.0 / (y.to(torch.float64) / self.scale)
                return self.encode(self.decode(x) * rec)
        return self._elementwise(div, a, b)

    def contract(self, a, b, subscripts: str):
        """Fixed-point binary einsum: per-product rescale, then integer sum.

        Products are shifted *before* accumulation so partial sums stay
        in range (the HLS flow sizes its accumulators identically).  As
        in the reference, each product is formed on the union index space
        of both operands and summed; no integer GEMM is used (the card
        has none).  Chunk rule: the union space is cut along its largest
        kept (output) index into pieces of at most
        :data:`CONTRACT_CHUNK_VALUES` values (never less than one index
        value), so no more than one chunk's broadcast exists at a time;
        an operand is widened (int64, or limbs) per chunk, after it is
        narrowed, never whole.  Each output entry is computed whole
        inside one chunk, so chunking never changes a bit."""
        in_spec, out_spec = subscripts.split("->")
        sa, sb = in_spec.split(",")
        union = sa + "".join(c for c in sb if c not in sa)
        dims: Dict[str, int] = {}
        for c, d in zip(sa, a.shape):
            dims[c] = d
        for c, d in zip(sb, b.shape):
            dims[c] = d

        def expand(x, s):
            perm = [s.index(c) for c in union if c in s]
            shape = tuple(dims[c] if c in s else 1 for c in union)
            return x.permute(perm).reshape(shape)  # a view: unit dims only

        def widen(x):
            if self.total_bits == 32:
                return x.to(torch.int64)
            return _split64(x)

        ea, eb = expand(a, sa), expand(b, sb)
        kept = [i for i, c in enumerate(union) if c in out_spec]
        sum_axes = [i for i, c in enumerate(union) if c not in out_spec]

        def products(pa, pb):
            if self.total_bits == 32:
                prod = pa * pb
                prod += 1 << (self.frac_bits - 1)
                prod >>= self.frac_bits
            else:
                prod = _fmul64(pa, pb, self.frac_bits)
            # int64 sums wrap modulo 2**64; the int32 cast wraps modulo
            # 2**32: the reference's wrapping int32 sum of products
            return prod.sum(dim=sum_axes) if sum_axes else prod

        if not kept:  # a full reduction: one output, one chunk
            return products(widen(ea), widen(eb)).to(self.storage_dtype)
        n_union = math.prod(dims[c] for c in union)
        axis = max(kept, key=lambda i: dims[union[i]])
        extent = dims[union[axis]]
        step = max(1, CONTRACT_CHUNK_VALUES // (n_union // extent))
        out = torch.empty([dims[union[i]] for i in kept],
                          dtype=self.storage_dtype, device=a.device)
        pos = kept.index(axis)
        # an operand the chunk axis does not cut is widened once; the
        # others are narrowed to the chunk first, then widened, so no
        # widened copy of a whole operand exists
        whole = [widen(x) if x.shape[axis] == 1 else None for x in (ea, eb)]

        def part(j, x, i0, n):
            return whole[j] if whole[j] is not None else widen(
                x.narrow(axis, i0, n))

        for i0 in range(0, extent, step):
            n = min(step, extent - i0)
            out.narrow(pos, i0, n).copy_(
                products(part(0, ea, i0, n), part(1, eb, i0, n)))
        remaining = [c for c in union if c in out_spec]
        return out.permute([remaining.index(c) for c in out_spec])


Policy = Union[FloatPolicy, FixedPointPolicy]

F64 = FloatPolicy("float64")
F32 = FloatPolicy("float32")
BF16 = FloatPolicy("bfloat16", accum_dtype="float32")
FIXED64 = FixedPointPolicy(64, 40)  # the paper's ap_fixed<64,24> (Q24.40)
FIXED32 = FixedPointPolicy(32, 24)  # the paper's ap_fixed<32,8>  (Q8.24)

POLICIES = {p.name: p for p in (F64, F32, BF16, FIXED64, FIXED32)}


def get_policy(name: str) -> Policy:
    """The policy registered under ``name``; :class:`ValueError` for
    names no package knows."""
    if name in POLICIES:
        return POLICIES[name]
    raise ValueError(f"unknown policy {name!r}; known: {sorted(POLICIES)}")


#: devices whose low-precision products take the card's route: the card,
#: and ``meta``, where the dry run (``launch.dryrun``) counts the card's
#: work without data
_CARD_LIKE = ("cuda", "meta")


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in float32, like the reference's
    ``einsum(..., preferred_element_type=float32)`` on bfloat16 operands.

    ``b`` is 2-D, or has ``a``'s leading (batch) dims.  On a CUDA card,
    bfloat16/float16 operands go to ``torch.mm``/``torch.bmm`` with
    ``out_dtype=torch.float32`` (no rounding to the low precision), and
    any other shape raises; that product is differentiable through
    :class:`_MatmulF32`; ``meta`` tensors take the same route.  On the
    CPU, which has no kernel for those overloads, and for float32
    operands, both are upcast to float32, which is exact for bfloat16
    values and accumulates in float32."""
    low = (torch.bfloat16, torch.float16)
    if a.device.type in _CARD_LIKE and (a.dtype in low or b.dtype in low):
        if a.dtype != b.dtype:
            raise TypeError(f"matmul_f32: operands of {a.dtype} and {b.dtype}")
        if not (b.dim() == 2 or (b.dim() == a.dim() >= 3
                                 and b.shape[:-2] == a.shape[:-2])):
            raise ValueError(
                f"matmul_f32: b {tuple(b.shape)} is neither 2-D nor batched "
                f"like a {tuple(a.shape)}"
            )
        return _MatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 for 2-D or 3-D (batched) operands of one
    dtype: ``out_dtype=float32`` on the card, an upcast on the CPU."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    if a.device.type in _CARD_LIKE and a.dtype != torch.float32:
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """The card's low-precision ``matmul_f32`` with a gradient.

    Forward: the float32-accumulated product, ``b`` 2-D (``a`` flattened
    to rows) or batched like ``a``.  Backward: the float32 cotangent is
    rounded to the operands' dtype -- as XLA's DEFAULT precision rounds
    it on a TPU -- and multiplied with the other operand, transposed, by
    the same float32-accumulated product; each gradient comes back in its
    operand's dtype (float32 operands: float32 throughout, exact)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if b.dim() == 2:
            out = _mm_f32(a.reshape(-1, a.shape[-1]), b)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        out = _mm_f32(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]))
        return out.reshape(*a.shape[:-2], *out.shape[-2:])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if b.dim() == 2:
            a2, g2 = a.reshape(-1, a.shape[-1]), g.reshape(-1, b.shape[-1])
            if ctx.needs_input_grad[0]:
                da = _mm_f32(g2, b.t()).reshape(a.shape).to(a.dtype)
            if ctx.needs_input_grad[1]:
                db = _mm_f32(a2.t(), g2).to(b.dtype)
            return da, db
        a3 = a.reshape(-1, *a.shape[-2:])
        b3 = b.reshape(-1, *b.shape[-2:])
        g3 = g.reshape(-1, *g.shape[-2:])
        if ctx.needs_input_grad[0]:
            da = _mm_f32(g3, b3.transpose(1, 2)).reshape(a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _mm_f32(a3.transpose(1, 2), g3).reshape(b.shape).to(b.dtype)
        return da, db
