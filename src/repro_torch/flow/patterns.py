"""Kernel pattern dispatch: match a stage program against the
hand-written kernels (the paper's "Optimize" step picking a specialized
CU).

``core.emit`` compiles ``backend='pallas'`` only when handed a concrete
``pallas_impl``; this module supplies it by *structural* matching -- a
stage program whose IR is isomorphic to a known kernel's program (same
einsum/ewise graph, same shapes, any input names) is dispatched to that
kernel, with the stage's actual input/output names adapted.  Unmatched
stages fall back to ``xla``.  The backend string stays ``pallas`` (the
reference's name, so reports compare byte for byte); here it means the
hand-written CUDA kernel.

Matching is name-insensitive: the flow's stage extraction renames
streams (the Fig. 2 ``u`` arrives as ``gx`` inside the CFD pipeline), so
signatures canonicalize subscripts and identify inputs positionally by
topological order.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

from ..core import dsl, ir, rewrite
from ..core.emit import einsum_spec
from ..kernels import _cube
from ..kernels import gemm as gemm_kernels
from ..kernels.helmholtz import ops as helmholtz_ops


def program_signature(prog: ir.Program) -> Tuple:
    """A name-insensitive structural key for a program.

    Two programs share a signature iff their value graphs are isomorphic
    with identical shapes and einsum/ewise semantics -- the input *names*
    are deliberately excluded so renamed streams still match.
    """
    order = prog.toposort()
    idx = {n.uid: i for i, n in enumerate(order)}
    sig = []
    for n in order:
        if isinstance(n, ir.Input):
            sig.append(("input", n.shape))
        elif isinstance(n, ir.Einsum):
            sig.append((
                "einsum", einsum_spec(n),
                tuple(idx[o.uid] for o in n.ops), n.shape,
            ))
        elif isinstance(n, ir.Ewise):
            sig.append((
                "ewise", n.op, n.const,
                tuple(idx[o.uid] for o in n.operands()), n.shape,
            ))
        else:  # pragma: no cover - no other node kinds exist
            sig.append(("other", n.shape))
    outs = tuple(idx[v.uid] for v in prog.outputs.values())
    return (tuple(sig), outs)


def _inputs_by_position(prog: ir.Program) -> Tuple[str, ...]:
    """Input names in topological (first-use) order -- the positional
    role order both sides of a signature match share."""
    name_of = {v.uid: k for k, v in prog.inputs.items()}
    return tuple(
        name_of[n.uid] for n in prog.toposort() if isinstance(n, ir.Input)
    )


@functools.lru_cache(maxsize=None)
def _helmholtz_reference(p: int) -> Tuple[Tuple, Tuple[str, ...]]:
    prog = rewrite.optimize(
        dsl.parse(
            dsl.INVERSE_HELMHOLTZ_SRC.format(p=p),
            element_vars=("u", "D", "v"),
        )
    )
    return program_signature(prog), _inputs_by_position(prog)


def match_inverse_helmholtz(
    prog: ir.Program,
) -> Optional[Tuple[Dict[str, str], str]]:
    """Does ``prog`` compute the fused Inverse-Helmholtz operator?

    Returns ``(rename, out_name)`` where ``rename`` maps the kernel's
    canonical input roles (``S``/``D``/``u``) to the program's actual
    input names, or None when the structure differs.
    """
    if len(prog.outputs) != 1 or len(prog.inputs) != 3:
        return None
    out_shape = next(iter(prog.outputs.values())).shape
    if len(out_shape) != 3 or len(set(out_shape)) != 1:
        return None
    p = out_shape[0]
    ref_sig, ref_roles = _helmholtz_reference(p)
    if program_signature(prog) != ref_sig:
        return None
    rename = dict(zip(ref_roles, _inputs_by_position(prog)))
    return rename, next(iter(prog.outputs))


def match_gemm_chain(
    prog: ir.Program,
) -> Optional[gemm_kernels.GemmRecipe]:
    """Does ``prog`` fit the tiled GEMM-chain kernel class?

    The class covers any stage whose nodes are (a) einsums contracting a
    shared ``(p, p)`` input matrix against one mode of an element-
    dependent all-``p`` tensor (output in the same index order), or (b)
    elementwise ops between already-matched values -- the interpolation
    and gradient stages, every schedule-derived single-contraction
    stage, and the stages the fusion pass merges.  Returns the kernel's
    :class:`~repro.kernels.gemm.GemmRecipe` (slots in topological
    order), or None when any node falls outside the class (the stage
    then falls back to ``xla``).
    """
    elem_dep = prog.element_dependent_uids()
    input_name = {v.uid: k for k, v in prog.inputs.items()}
    order = prog.toposort()

    # one p from the element inputs; every tensor axis must equal it
    p = None
    for n in order:
        if isinstance(n, ir.Input) and n.uid in elem_dep:
            if not n.shape or len(set(n.shape)) != 1:
                return None
            p = n.shape[0]
            break
    if p is None or p < 2:
        return None

    # recipe slots number every input first, then one slot per op, so
    # assign input slots up front (toposort interleaves the two)
    slots: Dict[int, int] = {}
    inputs = []
    for n in order:
        if isinstance(n, ir.Input):
            if any(d != p for d in n.shape):
                return None
            slots[n.uid] = len(slots)
            inputs.append((
                input_name[n.uid], tuple(n.shape), n.uid in elem_dep
            ))
    ops = []
    n_ops = 0

    for n in order:
        if isinstance(n, ir.Input):
            continue
        if isinstance(n, ir.Einsum):
            if len(n.ops) != 2 or n.uid not in elem_dep:
                return None
            # identify the shared (p, p) matrix operand
            mat_i = None
            for i, o in enumerate(n.ops):
                if (isinstance(o, ir.Input) and o.uid not in elem_dep
                        and o.shape == (p, p)):
                    mat_i = i
            if mat_i is None:
                return None
            x = n.ops[1 - mat_i]
            if x.uid not in slots or x.uid not in elem_dep:
                return None
            mat_subs = n.in_subs[mat_i]
            x_subs = n.in_subs[1 - mat_i]
            common = set(mat_subs) & set(x_subs)
            if len(common) != 1 or len(set(mat_subs)) != 2:
                return None
            (c,) = common
            if x_subs.count(c) != 1 or c in n.out_subs:
                return None
            f = mat_subs[0] if mat_subs[1] == c else mat_subs[1]
            mode = x_subs.index(c)
            in_place = [f if j == c else j for j in x_subs]
            out = tuple(n.out_subs)
            if sorted(out) != sorted(in_place) or len(set(out)) != len(out):
                return None
            perm = tuple(in_place.index(j) for j in out)
            if n.shape != x.shape:
                return None
            ops.append((
                "contract", slots[x.uid],
                slots[n.ops[mat_i].uid], mode,
                tuple(mat_subs).index(c), perm,
            ))
        elif isinstance(n, ir.Ewise):
            if n.op not in gemm_kernels.EWISE_OPS or n.uid not in elem_dep:
                return None
            operands = n.operands()
            if any(o.uid not in slots for o in operands):
                return None
            rhs = slots[operands[1].uid] if len(operands) > 1 else -1
            ops.append((
                "ewise", n.op, slots[operands[0].uid], rhs, n.const,
            ))
        else:
            return None
        slots[n.uid] = len(slots)
        n_ops += 1

    if not n_ops or not any(is_elem for _, _, is_elem in inputs):
        return None
    outputs = tuple(
        (name, slots[v.uid]) for name, v in prog.outputs.items()
    )
    return gemm_kernels.GemmRecipe(
        p=p, inputs=tuple(inputs), ops=tuple(ops), outputs=outputs,
    )


def pallas_impl_for(
    prog: ir.Program,
    *,
    block_elements: Optional[int] = None,
) -> Optional[Callable]:
    """A batched ``pallas_impl`` for ``core.emit.compile_program``, or
    None when no hand-written kernel matches the program.  The kernel
    launches at ``block_elements`` elements a CTA step (None: its
    default tile, :func:`kernel_tile_for`).

    Dispatch order: the fused Inverse-Helmholtz kernel first (its two
    ping-pong buffers are tighter than the generic chain's slots), then
    the GEMM-chain kernel class for everything else the class covers.
    """
    matched = match_inverse_helmholtz(prog)
    if matched is not None:
        rename, out_name = matched
        inner = helmholtz_ops.make_pallas_impl(block_elements=block_elements)

        def impl(env, out=None):
            res = inner({
                "S": env[rename["S"]],
                "D": env[rename["D"]],
                "u": env[rename["u"]],
            }, out=None if out is None else {"v": out[out_name]})
            return {out_name: res["v"]}

        return impl

    recipe = match_gemm_chain(prog)
    if recipe is None:
        return None
    return gemm_kernels.make_pallas_impl(recipe, block_elements=block_elements)


def kernel_tile_for(
    prog: ir.Program, elem_bytes: int, te: Optional[int] = None
) -> Optional[Tuple[int, int, int, int]]:
    """The CTA tile of the kernel :func:`pallas_impl_for` dispatches
    ``prog`` to, at ``te`` elements a step or (None) the kernel's
    default: ``(te, threads, shared bytes, largest te)``.  None when no
    kernel matches."""
    if match_inverse_helmholtz(prog) is not None:
        p = next(iter(prog.outputs.values())).shape[0]
        return (*_cube.helmholtz_tile(p, elem_bytes, te),
                _cube.helmholtz_max_tile(p, elem_bytes))
    recipe = match_gemm_chain(prog)
    if recipe is None:
        return None
    return (*gemm_kernels.gemm.kernel_tile(recipe, elem_bytes, te),
            gemm_kernels.gemm.kernel_max_tile(recipe, elem_bytes))
