"""Value-based tensor IR (the `teil` analogue).

Tensors are immutable values produced by nodes; there is no aliasing and no
array materialization at this level (buffers are assigned later, by the
scheduler + liveness passes).  The op vocabulary is intentionally small,
mirroring TeIL:

  * ``Input``  -- a named program input.
  * ``Einsum`` -- generalized product/contract/diag/transpose.  ``prod``,
    ``cont``, ``diag``, ``red`` and ``transpose`` from the paper all lower
    onto this single node.
  * ``Ewise``  -- element-wise arithmetic between same-shape values (the
    Hadamard product in the Inverse Helmholtz operator) or with a scalar.

Index bookkeeping uses integer "index ids" rather than letters so programs
are not limited to 52 axes.  Every node knows its output shape; shape
errors are raised at construction time (mirroring MLIR verifier behavior).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Shape = Tuple[int, ...]


class IRError(ValueError):
    """Raised on malformed IR construction (the 'verifier')."""


_node_counter = itertools.count()


@dataclasses.dataclass(eq=False)
class Node:
    """Base class for IR values."""

    shape: Shape

    def __post_init__(self) -> None:
        self.uid: int = next(_node_counter)

    # -- structural helpers -------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def operands(self) -> Tuple["Node", ...]:
        return ()

    def flops(self) -> int:
        """FLOPs to produce this value from its operands (not transitive)."""
        return 0


@dataclasses.dataclass(eq=False)
class Input(Node):
    name: str = ""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"%{self.uid} = input {self.name!r} : {list(self.shape)}"


@dataclasses.dataclass(eq=False)
class Einsum(Node):
    """Generalized einsum: multiply operands, sum over non-output ids.

    ``in_subs[k]`` gives one integer id per axis of operand ``k``;
    ``out_subs`` lists the ids of the result axes, in order.  Ids occurring
    in any ``in_subs`` but not in ``out_subs`` are contracted (summed).
    Repeated ids within one operand take the diagonal (teil.diag).
    """

    ops: Tuple[Node, ...] = ()
    in_subs: Tuple[Tuple[int, ...], ...] = ()
    out_subs: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        super().__post_init__()
        if len(self.ops) != len(self.in_subs):
            raise IRError("einsum: one subscript tuple per operand required")
        dims: Dict[int, int] = {}
        for op, subs in zip(self.ops, self.in_subs):
            if len(subs) != op.rank:
                raise IRError(
                    f"einsum: operand rank {op.rank} vs subscript rank {len(subs)}"
                )
            for idx, d in zip(subs, op.shape):
                if dims.setdefault(idx, d) != d:
                    raise IRError(
                        f"einsum: index {idx} bound to both {dims[idx]} and {d}"
                    )
        for idx in self.out_subs:
            if idx not in dims:
                raise IRError(f"einsum: output index {idx} unbound")
        expected = tuple(dims[i] for i in self.out_subs)
        if self.shape != expected:
            raise IRError(f"einsum: shape {self.shape} != inferred {expected}")
        self._dims = dims

    # -- analysis ------------------------------------------------------------
    def index_sizes(self) -> Dict[int, int]:
        return dict(self._dims)

    def contracted_ids(self) -> Tuple[int, ...]:
        seen = set(self.out_subs)
        return tuple(sorted(set(self._dims) - seen))

    def flops(self) -> int:
        """2 * prod(all index sizes) for true contractions (mul+add),
        1 * for pure products/transposes (mul only / free)."""
        total = 1
        for d in self._dims.values():
            total *= d
        if self.contracted_ids():
            return 2 * total
        if len(self.ops) > 1:
            return total  # pure (outer/Hadamard-like) product: one mul each
        return 0  # transpose / diagonal extraction

    def operands(self) -> Tuple[Node, ...]:
        return self.ops

    def __repr__(self) -> str:  # pragma: no cover
        subs = ",".join("".join(f"[{i}]" for i in s) for s in self.in_subs)
        out = "".join(f"[{i}]" for i in self.out_subs)
        return f"%{self.uid} = einsum {subs} -> {out} : {list(self.shape)}"


_EWISE_OPS = ("add", "sub", "mul", "div", "neg", "scale")


@dataclasses.dataclass(eq=False)
class Ewise(Node):
    op: str = "add"
    lhs: Optional[Node] = None
    rhs: Optional[Node] = None  # None for unary ops
    const: Optional[float] = None  # for 'scale'

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.op not in _EWISE_OPS:
            raise IRError(f"ewise: unknown op {self.op}")
        if self.lhs is None:
            raise IRError("ewise: lhs required")
        if self.op in ("add", "sub", "mul", "div"):
            if self.rhs is None or self.rhs.shape != self.lhs.shape:
                raise IRError(
                    f"ewise {self.op}: shape mismatch "
                    f"{self.lhs.shape} vs {None if self.rhs is None else self.rhs.shape}"
                )
        if self.shape != self.lhs.shape:
            raise IRError("ewise: output shape must equal operand shape")

    def flops(self) -> int:
        return self.size

    def operands(self) -> Tuple[Node, ...]:
        if self.rhs is None:
            return (self.lhs,)
        return (self.lhs, self.rhs)

    def __repr__(self) -> str:  # pragma: no cover
        return f"%{self.uid} = ewise.{self.op} : {list(self.shape)}"


# ---------------------------------------------------------------------------
# Convenience constructors mirroring the teil vocabulary
# ---------------------------------------------------------------------------

def _fresh_ids(n: int, start: int = 0) -> List[int]:
    return list(range(start, start + n))


def prod(a: Node, b: Node) -> Einsum:
    """teil.prod: outer product, shape = a.shape + b.shape."""
    ia = _fresh_ids(a.rank)
    ib = _fresh_ids(b.rank, start=a.rank)
    return Einsum(
        shape=a.shape + b.shape,
        ops=(a, b),
        in_subs=(tuple(ia), tuple(ib)),
        out_subs=tuple(ia + ib),
    )


def cont(x: Node, pairs: Sequence[Tuple[int, int]]) -> Einsum:
    """CFDlang '.' contraction over axis pairs of ``x`` (sum the diagonal).

    Axis numbers refer to ``x``'s axes.  Result drops both axes of each
    pair, keeping the remaining axes in order.
    """
    ids = _fresh_ids(x.rank)
    dropped = set()
    for i, j in pairs:
        if not (0 <= i < x.rank and 0 <= j < x.rank) or i == j:
            raise IRError(f"cont: bad pair ({i},{j}) for rank {x.rank}")
        if x.shape[i] != x.shape[j]:
            raise IRError(
                f"cont: axis sizes differ {x.shape[i]} vs {x.shape[j]}"
            )
        ids[j] = ids[i]
        dropped.add(i)
        dropped.add(j)
    out = tuple(ids[k] for k in range(x.rank) if k not in dropped)
    return Einsum(
        shape=tuple(x.shape[k] for k in range(x.rank) if k not in dropped),
        ops=(x,),
        in_subs=(tuple(ids),),
        out_subs=out,
    )


def diag(x: Node, i: int, j: int) -> Einsum:
    """teil.diag: identify axes i and j (keep axis i, drop axis j)."""
    if x.shape[i] != x.shape[j]:
        raise IRError("diag: axis sizes differ")
    ids = _fresh_ids(x.rank)
    ids[j] = ids[i]
    out = tuple(ids[k] for k in range(x.rank) if k != j)
    return Einsum(
        shape=tuple(x.shape[k] for k in range(x.rank) if k != j),
        ops=(x,),
        in_subs=(tuple(ids),),
        out_subs=out,
    )


def red(x: Node, axis: int) -> Einsum:
    """teil.red add: sum-reduce over ``axis``."""
    ids = _fresh_ids(x.rank)
    out = tuple(ids[k] for k in range(x.rank) if k != axis)
    return Einsum(
        shape=tuple(x.shape[k] for k in range(x.rank) if k != axis),
        ops=(x,),
        in_subs=(tuple(ids),),
        out_subs=out,
    )


def transpose(x: Node, perm: Sequence[int]) -> Einsum:
    ids = _fresh_ids(x.rank)
    return Einsum(
        shape=tuple(x.shape[p] for p in perm),
        ops=(x,),
        in_subs=(tuple(ids),),
        out_subs=tuple(ids[p] for p in perm),
    )


def add(a: Node, b: Node) -> Ewise:
    return Ewise(shape=a.shape, op="add", lhs=a, rhs=b)


def sub(a: Node, b: Node) -> Ewise:
    return Ewise(shape=a.shape, op="sub", lhs=a, rhs=b)


def mul(a: Node, b: Node) -> Ewise:
    return Ewise(shape=a.shape, op="mul", lhs=a, rhs=b)


def div(a: Node, b: Node) -> Ewise:
    return Ewise(shape=a.shape, op="div", lhs=a, rhs=b)


# ---------------------------------------------------------------------------
# Program container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Program:
    """A tensor-expression program (one CFDlang translation unit).

    ``element_vars`` marks which inputs carry a leading implicit element
    axis when batched (the paper's implicit outer element loop); the rest
    (e.g. the spectral operator ``S``) are shared across elements.
    """

    inputs: Dict[str, Input]
    outputs: Dict[str, Node]
    element_vars: Tuple[str, ...] = ()
    temps: Dict[str, Node] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        for v in self.element_vars:
            if v not in self.inputs and v not in self.outputs:
                raise IRError(f"element var {v!r} is not an input or output")

    # -- traversal -----------------------------------------------------------
    def toposort(self) -> List[Node]:
        """All nodes reachable from outputs, topologically ordered."""
        order: List[Node] = []
        seen = set()

        def visit(n: Node) -> None:
            if n.uid in seen:
                return
            seen.add(n.uid)
            for op in n.operands():
                visit(op)
            order.append(n)

        for out in self.outputs.values():
            visit(out)
        return order

    def total_flops(self) -> int:
        return sum(n.flops() for n in self.toposort())

    def element_dependent_uids(self) -> set:
        """Uids of values that (transitively) depend on an element-marked
        input -- i.e. values that carry the implicit element axis when the
        program is batched.  Everything else is batch-invariant (computed
        once from shared operands, like the paper's S matrix)."""
        dep = {
            v.uid for n, v in self.inputs.items() if n in self.element_vars
        }
        for node in self.toposort():
            if any(op.uid in dep for op in node.operands()):
                dep.add(node.uid)
        return dep

    def replace(self, mapping: Dict[int, Node]) -> "Program":
        """Return a program with nodes substituted per ``mapping`` (uid->node),
        rebuilding downstream nodes so operand links stay consistent."""
        cache: Dict[int, Node] = {}

        def rebuild(n: Node) -> Node:
            if n.uid in cache:
                return cache[n.uid]
            if n.uid in mapping and mapping[n.uid] is not n:
                # Rebuild *through* the replacement: its operands may refer
                # to nodes that are themselves mapped (e.g. a factorized
                # einsum consuming another rewritten value).
                rep = rebuild(mapping[n.uid])
                cache[n.uid] = rep
                return rep
            ops = n.operands()
            new_ops = tuple(rebuild(o) for o in ops)
            if all(a is b for a, b in zip(new_ops, ops)):
                cache[n.uid] = n
                return n
            if isinstance(n, Einsum):
                rep = Einsum(
                    shape=n.shape, ops=new_ops, in_subs=n.in_subs,
                    out_subs=n.out_subs,
                )
            elif isinstance(n, Ewise):
                rep = Ewise(
                    shape=n.shape, op=n.op, lhs=new_ops[0],
                    rhs=new_ops[1] if len(new_ops) > 1 else None,
                    const=n.const,
                )
            else:  # Input has no operands; unreachable
                rep = n
            cache[n.uid] = rep
            return rep

        new_outputs = {k: rebuild(v) for k, v in self.outputs.items()}
        return Program(
            inputs=self.inputs,
            outputs=new_outputs,
            element_vars=self.element_vars,
            temps={k: rebuild(v) for k, v in self.temps.items()},
        )

    def pretty(self) -> str:
        lines = []
        names = {v.uid: f"@{k}" for k, v in self.inputs.items()}
        for n in self.toposort():
            tag = names.get(n.uid, "")
            lines.append(f"{n!r} {tag}")
        for k, v in self.outputs.items():
            lines.append(f"yield @{k} = %{v.uid}")
        return "\n".join(lines)


def subprogram(
    nodes: Sequence[Node],
    inputs: Dict[str, Node],
    outputs: Dict[str, Node],
    element_vars: Sequence[str] = (),
) -> Program:
    """Rebuild a slice of a larger program as a standalone :class:`Program`.

    ``nodes`` are the slice's computation (topologically ordered);
    ``inputs`` names every boundary value the slice consumes (original
    program inputs or values produced outside the slice) -- each becomes a
    fresh :class:`Input` of the same shape; ``outputs`` names the slice's
    boundary results.  This is what the ``repro.flow`` stage extraction
    uses to turn scheduled groups into chain-stage programs.
    """
    placeholders: Dict[int, Node] = {
        v.uid: Input(shape=v.shape, name=name) for name, v in inputs.items()
    }
    rebuilt: Dict[int, Node] = dict(placeholders)
    for n in nodes:
        if n.uid in rebuilt:
            continue
        try:
            new_ops = tuple(rebuilt[op.uid] for op in n.operands())
        except KeyError as e:
            raise IRError(
                f"subprogram: node %{n.uid} consumes a value "
                f"({e.args[0]}) that is neither in the slice nor a "
                "declared boundary input"
            ) from e
        if isinstance(n, Einsum):
            rebuilt[n.uid] = Einsum(
                shape=n.shape, ops=new_ops, in_subs=n.in_subs,
                out_subs=n.out_subs,
            )
        elif isinstance(n, Ewise):
            rebuilt[n.uid] = Ewise(
                shape=n.shape, op=n.op, lhs=new_ops[0],
                rhs=new_ops[1] if len(new_ops) > 1 else None,
                const=n.const,
            )
        else:
            raise IRError(f"subprogram: cannot rebuild {n!r}")
    new_outputs: Dict[str, Node] = {}
    for name, v in outputs.items():
        if v.uid not in rebuilt:
            raise IRError(
                f"subprogram: output {name!r} is not produced by the slice"
            )
        new_outputs[name] = rebuilt[v.uid]
    return Program(
        inputs={name: placeholders[v.uid] for name, v in inputs.items()},
        outputs=new_outputs,
        element_vars=tuple(element_vars),
    )
