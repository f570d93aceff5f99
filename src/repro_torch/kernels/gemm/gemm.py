"""Generic GEMM-chain operator: the CUDA kernel's wrapper, its plain
PyTorch version, and the recipe both run.

A :class:`GemmRecipe` (built by ``flow.patterns.match_gemm_chain``)
describes any stage made of shared-matrix mode contractions and
elementwise ops -- the interpolation stage (three contractions with A),
the gradient stage (three outputs through Dx/Dy/Dz with perms), and any
single schedule-derived stage.  :func:`gemm_chain` is the port of the
reference's ``gemm_chain_pallas``: on CUDA tensors it launches
``csrc/gemm_chain.cu``, one generic kernel that reads the recipe from a
small int32 op table (:func:`op_table`) and its shared-memory cubes from
:func:`buffer_table`; on CPU tensors it runs :func:`gemm_chain_plain`.
Both sum every contraction over ``l`` in ascending order in float32, so
an element's result never depends on the block size or the batch split.
``block_elements`` is the kernel's tile ``te``, the elements a CTA takes
a step (None: the kernel's default, :func:`kernel_tile`); any E runs at
any legal tile, the last one ragged.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from .._cube import (MAX_P, MAX_SHARED_BYTES, chain_max_tile, chain_tile,
                     check_te)
from ..helmholtz.helmholtz import contract_mode

#: ewise ops the kernel (and the matcher) accept.
EWISE_OPS = ("add", "sub", "mul", "div", "neg", "scale")


@dataclasses.dataclass(frozen=True)
class GemmRecipe:
    """A hashable, IR-free description of one GEMM-chain stage.

    ``inputs`` lists every program input as ``(name, shape, is_element)``
    -- element tensors are rank-r all-``p`` cubes carrying the batch
    axis, shared inputs are ``(p, p)`` contraction matrices.  Value
    slots number the inputs first (in order) and then one slot per op
    result, so ``ops`` and ``outputs`` reference values positionally:

      * ``("contract", src_slot, mat_slot, mode, mat_dim, perm)`` --
        contract the matrix's ``mat_dim`` axis against tensor mode
        ``mode``, then permute the element-local axes of the in-place
        result by ``perm`` (identity for in-place contractions; the
        gradient einsums move the new free axis to the front);
      * ``("ewise", op, lhs_slot, rhs_slot, const)`` -- ``rhs_slot`` is
        ``-1`` for unary ops, ``const`` is None unless ``op=='scale'``.

    ``outputs`` maps output names to slots.
    """

    p: int
    inputs: Tuple[Tuple[str, Tuple[int, ...], bool], ...]
    ops: Tuple[Tuple, ...]
    outputs: Tuple[Tuple[str, int], ...]

    @property
    def n_inputs(self) -> int:
        return len(self.inputs)

    def slot_shape(self, slot: int) -> Tuple[int, ...]:
        """Element-local shape of a value slot (no batch axis)."""
        shapes = [shape for _, shape, _ in self.inputs]
        for op in self.ops:
            if op[0] == "contract":
                shapes.append(shapes[op[1]])
            else:
                shapes.append(shapes[op[2]])
        return shapes[slot]

    def flops_per_element(self) -> int:
        """Mirror of ``ir.Node.flops`` summed over the recipe."""
        total = 0
        for op in self.ops:
            if op[0] == "contract":
                total += 2 * self.p * math.prod(self.slot_shape(op[1]))
            else:
                total += math.prod(self.slot_shape(op[2]))
        return total


def apply_recipe(recipe: GemmRecipe, vals: List[torch.Tensor]) -> List[torch.Tensor]:
    """Run the op chain over float32 values (axis 0 of element values is
    the batch axis), in the kernel's arithmetic order."""
    vals = list(vals)
    for op in recipe.ops:
        if op[0] == "contract":
            _, src, mat, mode, mat_dim, perm = op
            m = vals[mat]
            # mat_dim 0: M(a, l) = m[l, a]; mat_dim 1: M(a, l) = m[a, l]
            y = contract_mode(vals[src], m.t() if mat_dim == 0 else m, mode)
            if tuple(perm) != tuple(range(len(perm))):
                y = y.permute((0,) + tuple(q + 1 for q in perm))
            vals.append(y)
        else:
            _, eop, lhs, rhs, const = op
            a = vals[lhs]
            if eop == "add":
                y = a + vals[rhs]
            elif eop == "sub":
                y = a - vals[rhs]
            elif eop == "mul":
                y = a * vals[rhs]
            elif eop == "div":
                y = a / vals[rhs]
            elif eop == "neg":
                y = -a
            elif eop == "scale":
                y = a * const
            else:
                raise ValueError(f"unknown ewise op {eop!r}")
            vals.append(y)
    return vals


def _batch(recipe: GemmRecipe, arrays) -> int:
    e = next(
        (a.shape[0] for (_, _, is_elem), a in zip(recipe.inputs, arrays)
         if is_elem),
        None,
    )
    if e is None:
        raise ValueError("recipe has no element input")
    return e


def gemm_chain_plain(
    recipe: GemmRecipe,
    env: Dict[str, torch.Tensor],
    *,
    block_elements: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the kernel.  Outputs take the dtype of the
    recipe's first input, as in the reference; they do not depend on
    ``block_elements`` (the kernel's tile)."""
    arrays = [env[name] for name, _, _ in recipe.inputs]
    _batch(recipe, arrays)
    vals = apply_recipe(recipe, [a.to(torch.float32) for a in arrays])
    out_dtype = arrays[0].dtype
    return {
        name: vals[slot].to(out_dtype).contiguous()
        for name, slot in recipe.outputs
    }


# ---------------------------------------------------------------------------
# the CUDA kernel's argument block (mirrors GemmChainArgs in gemm_chain.cu)
# ---------------------------------------------------------------------------

MAX_IN, MAX_OUT, MAX_OPS, MAX_MATS, OP_WIDTH = 8, 8, 32, 8, 10
#: element slots: one per element input and one per op result, so every
#: recipe within the other limits lowers (a slot is only an index; shared
#: memory follows :func:`buffer_table`'s work cubes)
MAX_SLOTS = MAX_IN + MAX_OPS
_EWISE_CODE = {op: i for i, op in enumerate(EWISE_OPS)}


class GemmChainArgs(ctypes.Structure):
    _fields_ = [
        ("inp", ctypes.c_void_p * MAX_IN),
        ("out", ctypes.c_void_p * MAX_OUT),
        ("n_in", ctypes.c_int), ("n_out", ctypes.c_int),
        ("n_ops", ctypes.c_int), ("n_slots", ctypes.c_int),
        ("n_mats", ctypes.c_int), ("p", ctypes.c_int),
        ("in_is_elem", ctypes.c_int * MAX_IN),
        ("in_index", ctypes.c_int * MAX_IN),
        ("out_slot", ctypes.c_int * MAX_OUT),
        ("ops", (ctypes.c_int * OP_WIDTH) * MAX_OPS),
        ("consts", ctypes.c_float * MAX_OPS),
        ("n_bufs", ctypes.c_int),
        ("slot_buf", ctypes.c_int * MAX_SLOTS),
    ]


def op_table(recipe: GemmRecipe):
    """Lower a recipe to the kernel's tables: element slots (inputs and op
    results) number the shared-memory cubes, matrices their own area.
    Returns ``(in_index, n_slots, n_mats, ops, consts, out_slot)``;
    raises for what the kernel does not take."""
    p = recipe.p
    where: Dict[int, Tuple[str, int]] = {}   # recipe slot -> (area, index)
    n_slots = n_mats = 0
    in_index = []
    for slot, (name, shape, is_elem) in enumerate(recipe.inputs):
        if is_elem:
            if tuple(shape) != (p, p, p):
                raise ValueError(
                    f"kernel takes rank-3 element cubes, input {name!r} is "
                    f"{tuple(shape)}"
                )
            where[slot] = ("slot", n_slots)
            in_index.append(n_slots)
            n_slots += 1
        else:
            if tuple(shape) != (p, p):
                raise ValueError(
                    f"kernel takes (p, p) shared matrices, input {name!r} "
                    f"is {tuple(shape)}"
                )
            where[slot] = ("mat", n_mats)
            in_index.append(n_mats)
            n_mats += 1

    def elem(slot: int) -> int:
        area, idx = where[slot]
        if area != "slot":
            raise ValueError(f"slot {slot} is a shared matrix, not an element value")
        return idx

    ops, consts = [], []
    for k, op in enumerate(recipe.ops):
        dst = n_slots
        if op[0] == "contract":
            _, src, mat, mode, mat_dim, perm = op
            area, m = where[mat]
            if area != "mat":
                raise ValueError(f"contract {k}: slot {mat} is not a matrix")
            row = [0, dst, elem(src), m, mode, mat_dim, *perm]
            consts.append(0.0)
        else:
            _, eop, lhs, rhs, const = op
            row = [1 + _EWISE_CODE[eop], dst, elem(lhs),
                   elem(rhs) if rhs >= 0 else -1]
            consts.append(float(const) if const is not None else 0.0)
        ops.append(row + [0] * (OP_WIDTH - len(row)))
        where[recipe.n_inputs + k] = ("slot", dst)
        n_slots += 1
    out_slot = [elem(slot) for _, slot in recipe.outputs]
    if (len(recipe.inputs) > MAX_IN or len(out_slot) > MAX_OUT
            or len(ops) > MAX_OPS or n_slots > MAX_SLOTS
            or n_mats > MAX_MATS):
        raise ValueError(
            f"recipe exceeds the kernel's static limits: {len(recipe.inputs)} "
            f"inputs (max {MAX_IN}), {len(out_slot)} outputs (max {MAX_OUT}), "
            f"{len(ops)} ops (max {MAX_OPS}), {n_slots} element slots "
            f"(max {MAX_SLOTS}), {n_mats} matrices (max {MAX_MATS})"
        )
    return in_index, n_slots, n_mats, ops, consts, out_slot


def buffer_table(recipe: GemmRecipe) -> Tuple[List[int], int]:
    """Shared-memory work cubes by liveness, beside :func:`op_table`.

    Returns ``(slot_buf, n_bufs)``: for each element slot of the op
    table, the f32 work cube that holds it, or -1.  Element inputs are
    read where they are staged (-1).  An op result gets a cube only if a
    later op reads it; a cube is free again once its slot's last reader
    has run, or for that reader itself where it writes in place: an
    ewise op (each thread writes the entries it reads) or a contraction
    without a perm (each thread writes the fibers it reads).  A result
    that only feeds outputs is stored from registers (-1).
    Interpolation takes 1 cube, the gradient stage none."""
    _, n_slots, _, ops, _, _ = op_table(recipe)
    last_read: Dict[int, int] = {}      # element slot -> its last reader
    for k, row in enumerate(ops):
        for s in ([row[2]] if row[0] == 0 else [row[2], row[3]]):
            if s >= 0:
                last_read[s] = k
    slot_buf = [-1] * n_slots
    busy_until: List[int] = []          # per cube: its slot's last reader
    for k, row in enumerate(ops):
        dst = row[1]
        if last_read.get(dst, -1) <= k:
            continue
        in_place = row[0] != 0 or list(row[6:9]) == [0, 1, 2]
        free = [b for b, until in enumerate(busy_until)
                if until < k or (until == k and in_place)]
        b = free[0] if free else len(busy_until)
        if b == len(busy_until):
            busy_until.append(0)
        busy_until[b] = last_read[dst]
        slot_buf[dst] = b
    return slot_buf, len(busy_until)


def _cube_counts(recipe: GemmRecipe) -> Tuple[int, int, int]:
    """(element inputs, matrices, work cubes) of a recipe on the kernel."""
    _, n_bufs = buffer_table(recipe)
    n_elem = sum(1 for _, _, is_elem in recipe.inputs if is_elem)
    return n_elem, len(recipe.inputs) - n_elem, n_bufs


def kernel_tile(recipe: GemmRecipe, elem_bytes: int,
                te: Optional[int] = None) -> Tuple[int, int, int]:
    """The kernel's CTA tile for a recipe, ``(te, threads, shared
    bytes)``, at ``te`` or (None) its default (``_cube.chain_tile`` with
    the work cubes of :func:`buffer_table`).  Raises where even one
    element a tile does not fit a block's shared memory: at p = 16 in
    float32, a recipe with eight element inputs (two staging buffers of
    16,400 B each)."""
    n_elem, n_mats, n_bufs = _cube_counts(recipe)
    tile = chain_tile(recipe.p, n_elem, n_mats, n_bufs, elem_bytes, te)
    if te is None and tile[2] > MAX_SHARED_BYTES:
        raise ValueError(
            f"the GEMM-chain kernel on this recipe at p={recipe.p} needs "
            f"{tile[2]} B of shared memory per CTA (limit {MAX_SHARED_BYTES})"
        )
    return tile


def kernel_max_tile(recipe: GemmRecipe, elem_bytes: int) -> int:
    """The largest ``te`` the kernel launches with for a recipe (0 where
    not even one element fits)."""
    n_elem, n_mats, n_bufs = _cube_counts(recipe)
    return chain_max_tile(recipe.p, n_elem, n_mats, n_bufs, elem_bytes)


def chain_args(recipe: GemmRecipe, in_ptrs, out_ptrs) -> GemmChainArgs:
    """The kernel's argument block for a recipe: its op table
    (:func:`op_table`), its work cubes (:func:`buffer_table`) and the
    device pointers of its inputs and outputs, in recipe order."""
    in_index, n_slots, n_mats, ops, consts, out_slot = op_table(recipe)
    slot_buf, n_bufs = buffer_table(recipe)
    args = GemmChainArgs()
    for j, ((_, _, is_elem), ptr) in enumerate(zip(recipe.inputs, in_ptrs)):
        args.inp[j] = ptr
        args.in_is_elem[j] = int(is_elem)
        args.in_index[j] = in_index[j]
    for j, ptr in enumerate(out_ptrs):
        args.out[j] = ptr
        args.out_slot[j] = out_slot[j]
    for k, row in enumerate(ops):
        for c, v in enumerate(row):
            args.ops[k][c] = v
        args.consts[k] = consts[k]
    args.n_in, args.n_out, args.n_ops = len(in_ptrs), len(out_ptrs), len(ops)
    args.n_slots, args.n_mats, args.p = n_slots, n_mats, recipe.p
    args.n_bufs = n_bufs
    for s, b in enumerate(slot_buf):
        args.slot_buf[s] = b
    return args


def _check_abi(lib) -> None:
    """The ctypes mirror must match the compiled struct and limits."""
    got = (ctypes.c_int * 7)()
    lib.repro_gemm_chain_limits(got)
    want = (MAX_IN, MAX_OUT, MAX_OPS, MAX_SLOTS, MAX_MATS, OP_WIDTH,
            ctypes.sizeof(GemmChainArgs))
    if tuple(got) != want:
        raise RuntimeError(
            f"GemmChainArgs mismatch: library {tuple(got)}, Python {want}"
        )


def gemm_chain(
    recipe: GemmRecipe,
    env: Dict[str, torch.Tensor],
    *,
    block_elements: Optional[int] = None,
    out: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Run one recipe.  ``env`` maps the recipe's input names to tensors
    (element tensors batched on axis 0).  CUDA tensors launch the kernel
    at ``block_elements`` elements a CTA step (None: its default tile),
    refusing a tile it cannot launch with before the launch; CPU tensors
    run the plain version.  ``out`` maps every output name to a
    contiguous tensor of its batched shape and the inputs' dtype (a
    slice of a larger batch's output, say), which receives it and is
    returned.  ``gemm_chain.launches`` counts kernel launches."""
    arrays = [env[name] for name, _, _ in recipe.inputs]
    e = _batch(recipe, arrays)
    devices = {a.device for a in arrays}
    if out is not None:
        if set(out) != {name for name, _ in recipe.outputs}:
            raise ValueError(f"out names {sorted(out)} are not the recipe's "
                             f"outputs {[n for n, _ in recipe.outputs]}")
        for name, slot in recipe.outputs:
            o = out[name]
            want = (e,) + recipe.slot_shape(slot)
            if (tuple(o.shape) != want or o.dtype != arrays[0].dtype
                    or not o.is_contiguous()):
                raise ValueError(
                    f"out {name!r} must be contiguous {arrays[0].dtype} "
                    f"{want}, got {o.dtype} {tuple(o.shape)}")
            devices.add(o.device)
    if len(devices) != 1:
        raise ValueError(f"recipe inputs and outputs lie on different "
                         f"devices: {devices}")
    (device,) = devices
    if device.type == "cpu":
        res = gemm_chain_plain(recipe, env, block_elements=block_elements)
        if out is None:
            return res
        return {name: out[name].copy_(res[name]) for name, _ in recipe.outputs}
    if device.type != "cuda":
        raise ValueError(f"no GEMM-chain kernel for device {device}")
    from .. import _cuda

    dtypes = {a.dtype for a in arrays}
    if len(dtypes) != 1:
        raise TypeError(f"recipe inputs must share one dtype, got {dtypes}")
    code = _cuda.dtype_code(arrays[0].dtype)
    for (name, shape, is_elem), a in zip(recipe.inputs, arrays):
        want = ((e,) + tuple(shape)) if is_elem else tuple(shape)
        if tuple(a.shape) != want:
            raise ValueError(f"input {name!r}: shape {tuple(a.shape)} != {want}")
        if not a.is_contiguous():
            raise ValueError(f"input {name!r} is not contiguous")
    if recipe.p > MAX_P:
        raise ValueError(f"kernel supports p <= {MAX_P}, got {recipe.p}")
    eb = arrays[0].element_size()
    default_te = kernel_tile(recipe, eb)[0]  # raises where nothing fits
    te = block_elements or default_te
    check_te("GEMM-chain", recipe.p, te, kernel_max_tile(recipe, eb))
    outs = out if out is not None else {
        name: torch.empty((e,) + recipe.slot_shape(slot), dtype=arrays[0].dtype,
                          device=device)
        for name, slot in recipe.outputs
    }
    args = chain_args(recipe, [a.data_ptr() for a in arrays],
                      [outs[name].data_ptr() for name, _ in recipe.outputs])
    lib = _cuda.library()
    _check_abi(lib)
    with _cuda.launch_on(device) as stream:
        err = lib.repro_gemm_chain(ctypes.addressof(args), e, code, te, stream)
    _cuda.check(err, "gemm_chain")
    gemm_chain.launches += 1
    return outs


gemm_chain.launches = 0
