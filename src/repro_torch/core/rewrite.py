"""Middle-end rewrites (the `teil` transformation analogue).

The centerpiece is *contraction factorization* (paper Fig. 10): a
contraction applied to a chain of outer products, e.g. the Inverse
Helmholtz stage ``(S (x) S (x) S (x) u)`` contracted over three index
pairs, is O(p^6) if evaluated literally.  Associativity/distributivity let
the contraction be pulled down onto the factors, yielding a chain of three
O(p^4) GEMMs.  We implement this as:

  1. ``flatten_products``  -- inline pure-product operands into their
     consuming einsum, producing one multi-operand einsum ("operator
     graph" view);
  2. ``factorize``         -- optimal binary contraction tree via
     dynamic programming over operand subsets (exact for <= 10 operands,
     greedy beyond), replacing the node with a chain of binary einsums;
  3. ``cse`` / dead code   -- hash-consing; DCE is implicit (programs are
     traversed from outputs).

All rewrites are semantics-preserving over R (abstract scalars), mirroring
teil's "strictly beneficial mathematical identities".
"""
from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from . import ir

# ---------------------------------------------------------------------------
# flatten: inline contraction-free einsum operands (outer products, diags,
# transposes) into the consuming einsum.
# ---------------------------------------------------------------------------


def _is_contraction_free(e: ir.Einsum) -> bool:
    return not e.contracted_ids()


def _flatten_node(n: ir.Node) -> ir.Node:
    if not isinstance(n, ir.Einsum):
        return n
    changed = True
    node = n
    while changed:
        changed = False
        for k, op in enumerate(node.ops):
            if not isinstance(op, ir.Einsum) or not _is_contraction_free(op):
                continue
            # map: child's output axis -> parent id for that axis
            axis_to_parent = dict(zip(op.out_subs, node.in_subs[k]))
            # child ids all appear in child's out_subs (contraction-free)
            new_ops: List[ir.Node] = list(node.ops[:k]) + list(op.ops) + list(
                node.ops[k + 1:]
            )
            new_subs: List[Tuple[int, ...]] = list(node.in_subs[:k])
            for child_op, child_subs in zip(op.ops, op.in_subs):
                new_subs.append(
                    tuple(axis_to_parent[cid] for cid in child_subs)
                )
            new_subs.extend(node.in_subs[k + 1:])
            node = ir.Einsum(
                shape=node.shape,
                ops=tuple(new_ops),
                in_subs=tuple(new_subs),
                out_subs=node.out_subs,
            )
            changed = True
            break
    return node


def flatten_products(prog: ir.Program) -> ir.Program:
    mapping: Dict[int, ir.Node] = {}
    for n in prog.toposort():
        if isinstance(n, ir.Einsum):
            flat = _flatten_node(n)
            if flat is not n:
                mapping[n.uid] = flat
    return prog.replace(mapping) if mapping else prog


# ---------------------------------------------------------------------------
# factorize: optimal pairwise contraction ordering (Held-Karp style DP).
# ---------------------------------------------------------------------------


def _lower_diagonals(e: ir.Einsum) -> ir.Einsum:
    """Ensure every operand has distinct subscript ids by extracting
    diagonals into unary einsums, so the DP can treat terms as id-sets."""
    new_ops: List[ir.Node] = []
    new_subs: List[Tuple[int, ...]] = []
    for op, subs in zip(e.ops, e.in_subs):
        if len(set(subs)) == len(subs):
            new_ops.append(op)
            new_subs.append(subs)
            continue
        # unary einsum taking the diagonal: keep first occurrence of each id
        kept: List[int] = []
        for s in subs:
            if s not in kept:
                kept.append(s)
        sizes = dict(zip(subs, op.shape))
        diag_node = ir.Einsum(
            shape=tuple(sizes[i] for i in kept),
            ops=(op,),
            in_subs=(subs,),
            out_subs=tuple(kept),
        )
        new_ops.append(diag_node)
        new_subs.append(tuple(kept))
    return ir.Einsum(
        shape=e.shape, ops=tuple(new_ops), in_subs=tuple(new_subs),
        out_subs=e.out_subs,
    )


def _pair_cost(
    ids_a: FrozenSet[int],
    ids_b: FrozenSet[int],
    needed_later: FrozenSet[int],
    sizes: Dict[int, int],
) -> Tuple[int, FrozenSet[int]]:
    union = ids_a | ids_b
    out = frozenset(i for i in union if i in needed_later)
    flops = 2
    for i in union:
        flops *= sizes[i]
    return flops, out


def _optimal_path(
    term_ids: List[FrozenSet[int]],
    out_ids: FrozenSet[int],
    sizes: Dict[int, int],
) -> List[Tuple[int, int]]:
    """Return a list of (i, j) merges over term indices (Held-Karp DP).

    After each merge the combined term replaces index i and index j is
    removed; indices refer to the current term list (like np.einsum_path).
    For > 10 terms fall back to greedy cheapest-pair.
    """
    n = len(term_ids)
    if n <= 1:
        return []
    if n > 10:
        return _greedy_path(term_ids, out_ids, sizes)

    full = (1 << n) - 1

    def needed_later(subset: int) -> FrozenSet[int]:
        """Ids needed outside ``subset``: program outputs + other terms."""
        need = set(out_ids)
        for k in range(n):
            if not subset & (1 << k):
                need |= term_ids[k]
        return frozenset(need)

    # DP over subsets: best[(subset)] = (cost, ids, tree)
    best: Dict[int, Tuple[int, FrozenSet[int], object]] = {}
    for k in range(n):
        best[1 << k] = (0, term_ids[k], k)
    subsets_by_size: Dict[int, List[int]] = {}
    for s in range(1, full + 1):
        subsets_by_size.setdefault(bin(s).count("1"), []).append(s)
    for size in range(2, n + 1):
        for s in subsets_by_size[size]:
            need = needed_later(s)
            best_here: Optional[Tuple[int, FrozenSet[int], object]] = None
            # iterate proper sub-splits (canonical: lowest bit stays left)
            sub = (s - 1) & s
            while sub:
                other = s ^ sub
                if sub & (s & -s):  # dedupe mirrored splits
                    if sub in best and other in best:
                        ca, ia, ta = best[sub]
                        cb, ib, tb = best[other]
                        fl, out = _pair_cost(ia, ib, need, sizes)
                        tot = ca + cb + fl
                        if best_here is None or tot < best_here[0]:
                            best_here = (tot, out, (ta, tb))
                sub = (sub - 1) & s
            assert best_here is not None
            best[s] = best_here

    # unparse tree into merge list over dynamic indices
    merges: List[Tuple[int, int]] = []

    def emit(tree: object) -> int:
        if isinstance(tree, int):
            return tree
        a, b = tree  # type: ignore[misc]
        ia, ib = emit(a), emit(b)
        merges.append((ia, ib))
        return ia

    emit(best[full][2])
    return merges


def _greedy_path(
    term_ids: List[FrozenSet[int]],
    out_ids: FrozenSet[int],
    sizes: Dict[int, int],
) -> List[Tuple[int, int]]:
    alive = {k: term_ids[k] for k in range(len(term_ids))}
    merges: List[Tuple[int, int]] = []
    while len(alive) > 1:
        best = None
        keys = sorted(alive)
        for i, j in itertools.combinations(keys, 2):
            need = set(out_ids)
            for k, ids in alive.items():
                if k != i and k != j:
                    need |= ids
            fl, out = _pair_cost(alive[i], alive[j], frozenset(need), sizes)
            if best is None or fl < best[0]:
                best = (fl, i, j, out)
        _, i, j, out = best  # type: ignore[misc]
        merges.append((i, j))
        alive[i] = out
        del alive[j]
    return merges


def _factorize_node(e: ir.Einsum) -> ir.Node:
    if len(e.ops) <= 2:
        return e
    e = _lower_diagonals(e)
    sizes = e.index_sizes()
    terms: List[ir.Node] = list(e.ops)
    ids: List[FrozenSet[int]] = [frozenset(s) for s in e.in_subs]
    subs: List[Tuple[int, ...]] = list(e.in_subs)
    out_ids = frozenset(e.out_subs)
    merges = _optimal_path(ids, out_ids, sizes)
    for i, j in merges:
        need = set(out_ids)
        for k in range(len(terms)):
            if k != i and k != j and terms[k] is not None:
                need |= ids[k]
        union_ids = ids[i] | ids[j]
        keep = tuple(sorted(x for x in union_ids if x in need))
        shape = tuple(sizes[x] for x in keep)
        node = ir.Einsum(
            shape=shape,
            ops=(terms[i], terms[j]),
            in_subs=(subs[i], subs[j]),
            out_subs=keep,
        )
        terms[i], ids[i], subs[i] = node, frozenset(keep), keep
        terms[j] = None  # type: ignore[assignment]
    root_idx = merges[-1][0] if merges else 0
    root = terms[root_idx]
    # final transpose/selection to requested output order
    if subs[root_idx] != e.out_subs:
        root = ir.Einsum(
            shape=e.shape,
            ops=(root,),
            in_subs=(subs[root_idx],),
            out_subs=e.out_subs,
        )
    return root


def factorize(prog: ir.Program) -> ir.Program:
    mapping: Dict[int, ir.Node] = {}
    for n in prog.toposort():
        if isinstance(n, ir.Einsum) and len(n.ops) > 2:
            fac = _factorize_node(n)
            if fac is not n:
                mapping[n.uid] = fac
    return prog.replace(mapping) if mapping else prog


# ---------------------------------------------------------------------------
# CSE: hash-cons structurally identical nodes (S appears three times in the
# Helmholtz chain; the rebuilt GEMM stages share it automatically).
# ---------------------------------------------------------------------------


def _canon_einsum_key(e: ir.Einsum, op_keys: Tuple[int, ...]) -> tuple:
    remap: Dict[int, int] = {}

    def c(i: int) -> int:
        if i not in remap:
            remap[i] = len(remap)
        return remap[i]

    subs = tuple(tuple(c(i) for i in s) for s in e.in_subs)
    out = tuple(c(i) for i in e.out_subs)
    return ("einsum", op_keys, subs, out, e.shape)


def cse(prog: ir.Program) -> ir.Program:
    key_to_node: Dict[tuple, ir.Node] = {}
    node_key: Dict[int, tuple] = {}
    mapping: Dict[int, ir.Node] = {}

    def keyof(n: ir.Node) -> tuple:
        return node_key[n.uid]

    for n in prog.toposort():
        if isinstance(n, ir.Input):
            k = ("input", n.name, n.shape)
        elif isinstance(n, ir.Einsum):
            k = _canon_einsum_key(n, tuple(id(key_to_node[keyof(o)]) for o in n.ops))
        elif isinstance(n, ir.Ewise):
            ops = tuple(id(key_to_node[keyof(o)]) for o in n.operands())
            k = ("ewise", n.op, n.const, ops, n.shape)
        else:
            k = ("other", n.uid)
        node_key[n.uid] = k
        if k in key_to_node:
            if key_to_node[k] is not n:
                mapping[n.uid] = key_to_node[k]
        else:
            key_to_node[k] = n
    return prog.replace(mapping) if mapping else prog


# ---------------------------------------------------------------------------
# Pipeline entry point
# ---------------------------------------------------------------------------


def optimize(prog: ir.Program, *, factorize_contractions: bool = True) -> ir.Program:
    """The standard middle-end pipeline: flatten -> factorize -> cse.

    With ``factorize_contractions=False`` the program stays in its literal
    (paper 'naive O(p^6)') form -- used as the unoptimized baseline.
    """
    prog = flatten_products(prog)
    if factorize_contractions:
        prog = factorize(prog)
    prog = cse(prog)
    return prog
