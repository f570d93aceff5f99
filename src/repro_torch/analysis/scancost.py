"""Loop-aware cost composition, the port's counterpart of the
reference's ``repro/analysis/scancost.py``.

XLA's ``cost_analysis`` counts a while-loop body once whatever its trip
count, so the reference compiles each scanned body alone and composes
``outer + (trips - 1) x body``.  The port's dry run (``launch.dryrun``)
counts every pass of its Python loops, so the dense, MoE, VLM and
encoder-decoder cells need no correction: :func:`corrections` returns
zeros for them, as the reference's does for the encoder-decoder.

What it cannot do is run the long ones.  The xLSTM's mLSTM and sLSTM
layers and jamba's Mamba layers step through the sequence in Python, a
few DTensor ops a step at tens of microseconds each: jamba's
``train_4k`` is 63 Mamba layers x 4,096 steps, forward, recompute and
backward, and ``prefill_32k`` 32,768 steps.  For those cells (the
sequence cells of the two families; a decode cell is one step) the dry
run runs the same cell at four short lengths and :func:`corrections`
composes the full one:

  * the matrix-product FLOPs and the collective bytes of such a cell
    are a polynomial in the sequence length ``T`` of degree 2 at most --
    a step loop adds a fixed cost a step, a projection, norm, loss or
    MoE dispatch a fixed cost a token, a cache-less attention layer
    (jamba's one in eight) a cost per pair of positions (a prefill's
    prompt attends to the whole cache, whose length does not change);
  * so the counts at the first three lengths fix the polynomial
    (:data:`DEGREE`), and the fourth checks it: the composition is exact
    where the check holds (``detail["check"]``).  The lengths are chosen
    so that the MoE capacity (``_moe_capacity``, at least 8 slots a
    group) is linear in them over the whole range, and at multiples of
    ``MLSTM_CHUNK`` above it for the chunked mLSTM.

The bytes and memory fields are composed alike and held to the same
check: a step loop reads its steps as the views of one ``unbind``, so
its backward writes O(T) bytes, as the scan's does.  Where a field's
check fails it is extrapolated along the line through the two longest
runs instead (:func:`compose`), and is a model of the full cell, not a
count of it: the line carries the samples (T <= 32, or a few chunks)
128-1,000 times further out, and its error there is not measured.
``analysis.aggregate`` marks each such field.  A check fails where the
cell changes regime between the samples: DTensor picks a product's or a
redistribution's layout by its cost, which grows with ``T``
(xlstm-125m's ``train_4k``: its sLSTM gate products, float32 by
DTensor's own ``mm`` rule, gather their (768, 768) weights at T <= 24
and split their contraction at 32 -- its bytes, temporaries and three
collective kinds; jamba's cells), or the peak moves from one tensor to
another (xlstm-125m's ``prefill_32k``: the steps' state pieces at T =
8, the loop's output gathered for its output projection from 16 on,
linear from there).  The model modules stay unaware of the dry run;
the reference's x3 and x4 backward factors (its probes of a step's
forward only) are not needed.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Any, Dict, Optional, Sequence, Tuple

from ..configs import shapes as shape_mod
from ..launch import mesh as mesh_mod
from ..models.config import ModelConfig

#: the shortest length a composed cell runs at, and its step
BASE_T = 8
#: the degree in ``T`` of the polynomial the counts are composed by
DEGREE = 2
LOOPING = ("ssm_xlstm", "hybrid_jamba")


def _moe_linear(cfg: ModelConfig, batch: int, lengths, groups: int) -> bool:
    """Whether the dry run's MoE capacity -- ``max(int(B T k / E f), 8)``
    over ``groups`` groups of at least 8 slots -- is linear in ``T`` over
    ``lengths``: exact divisions and no floor reached."""
    if cfg.moe is None:
        return True
    m = cfg.moe
    f = Fraction(m.capacity_factor).limit_denominator(1000)
    for t in lengths:
        cap = Fraction(batch * t * m.top_k, m.n_experts) * f
        if (cap.denominator != 1 or (batch * t) % groups
                or cap % groups or cap // groups < 8):
            return False
    return True


def loop_lengths(cfg: ModelConfig, shape_name: str, mesh, *,
                 mlstm_chunk: Optional[int] = None
                 ) -> Optional[Tuple[int, ...]]:
    """The four short sequence lengths to run a looping cell at (from
    multiples of :data:`BASE_T`), or None when the cell runs whole
    (another family, a decode cell, or a sequence no longer than the
    lengths)."""
    spec = shape_mod.SHAPES[shape_name]
    if cfg.family not in LOOPING or spec.kind == "decode":
        return None
    sizes = mesh_mod.axis_sizes(mesh)
    groups = 1
    for a in mesh_mod.data_axes(mesh):
        groups *= sizes[a]
    base, first = BASE_T, 1
    if cfg.family == "ssm_xlstm" and mlstm_chunk:
        # the chunked mLSTM runs only above one chunk, on whole chunks
        base, first = mlstm_chunk, 2
    while True:
        lengths = tuple(base * i for i in range(first, first + 4))
        if lengths[-1] >= spec.seq_len:
            return None
        if _moe_linear(cfg, spec.global_batch, lengths, groups):
            return lengths
        base *= 2


def _lagrange(points: Sequence[Tuple[int, int]], x: int) -> Fraction:
    total = Fraction(0)
    for i, (xi, yi) in enumerate(points):
        term = Fraction(yi)
        for j, (xj, _) in enumerate(points):
            if j != i:
                term *= Fraction(x - xj, xi - xj)
        total += term
    return total


def _numbers(counts) -> Dict[str, int]:
    """The composed fields of a dry-run count, flat."""
    out = {"flops": counts["flops"], "bytes": counts["bytes"]}
    out.update({f"coll/{k}": v for k, v in counts["collectives"].items()})
    out.update({f"memory/{k}": v for k, v in counts["memory"].items()})
    return out


def compose(samples: Dict[int, Any], T: int
            ) -> Tuple[Dict[str, int], Dict[str, bool]]:
    """Each field of the counts at ``T``, by the polynomial of degree
    :data:`DEGREE` through the first ``DEGREE + 1`` samples where it
    also meets every other sample (``exact``); else by the line through
    the two longest samples, never below the longest (a model: a
    polynomial fitted where it is not one can turn negative so far out)."""
    lengths = sorted(samples)
    flat = {t: _numbers(samples[t]) for t in lengths}
    fit, rest = lengths[:DEGREE + 1], lengths[DEGREE + 1:]
    (t1, t2) = lengths[-2:]
    value, exact = {}, {}
    for name in flat[lengths[0]]:
        pts = [(t, flat[t][name]) for t in fit]
        v = _lagrange(pts, T)
        exact[name] = v.denominator == 1 and all(
            _lagrange(pts, t) == flat[t][name] for t in rest)
        if not exact[name]:
            y1, y2 = flat[t1][name], flat[t2][name]
            v = max(Fraction(y2), y2 + Fraction(y2 - y1, t2 - t1) * (T - t2))
        value[name] = round(v)
    return value, exact


def corrections(cfg: ModelConfig, shape_name: str,
                samples: Dict[int, Any], *,
                mlstm_chunk: Optional[int] = None) -> Dict[str, Any]:
    """What to ADD to the counts of the shortest sample (the one the
    record carries) to give the cell at its full length: ``flops``,
    ``bytes``, ``coll`` (and by kind, ``coll_breakdown``), with the
    composed ``memory`` fields and a ``detail`` of the samples and the
    check.  One sample (a cell run whole): zeros, its memory."""
    spec = shape_mod.SHAPES[shape_name]
    lengths = sorted(samples)
    base = samples[lengths[0]]
    kinds = list(base["collectives"])
    if len(lengths) == 1:
        return {"flops": 0.0, "bytes": 0.0, "coll": 0.0,
                "coll_breakdown": dict.fromkeys(kinds, 0),
                "memory": dict(base["memory"]), "detail": {}}
    value, exact = compose(samples, spec.seq_len)
    coll = {k: value[f"coll/{k}"] - base["collectives"][k] for k in kinds}
    return {
        "flops": float(value["flops"] - base["flops"]),
        "bytes": float(value["bytes"] - base["bytes"]),
        "coll": float(sum(coll.values())),
        "coll_breakdown": coll,
        "memory": {k.split("/", 1)[1]: v for k, v in value.items()
                   if k.startswith("memory/")},
        "detail": {
            "lengths": lengths, "degree": DEGREE, "seq_len": spec.seq_len,
            "mlstm_chunk": mlstm_chunk,
            "flops_at": [samples[t]["flops"] for t in lengths],
            "check": exact,
        },
    }
