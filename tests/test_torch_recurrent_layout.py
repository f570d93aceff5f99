"""The recurrent families' sharded cells step each rank's own rows: the
xLSTM (the recurrent mLSTM, and the chunked one at ``MLSTM_CHUNK = 8``)
and jamba, at their smoke configs, as the dry run builds them
(``launch.dryrun.count_cell``: prefill and the train step on ``meta``,
rank 0 of a fake group) at B = 8, T = 16 on (data, model) meshes (4, 1),
(2, 2) and (1, 4) (there at T = 24: q's (B, H, T, hd) is then no
state's shape).

Recorded while a cell runs, but for the optimizer's update: every
DTensor op's output (its global shape beside rank 0's local one, as
DTensor wraps them; not an expansion without storage of its own, such
as the loss's mean broadcast over the batch in the backward) and
every factory op that the meter counts (a
``zeros`` of a global shape is the model's or autograd's, never a
shard).  A dim 0 or 1 of global size B is a batch dim where the same
record of the cell run at 2B has 2B there (the two runs aligned op by
op): a chunk width of 8 is not.  Held:

* on (4, 1) and (2, 2), no recorded tensor holds more than B / data
  rows of a batch dim (the xLSTM's states were zeros of the global
  batch, its forget gate ran whole, and its steps gathered the rows of
  every step);
* on (1, 4), the mLSTM's state C (B, H, hd, hd) is split over
  ``model`` on every rank: no tensor of its global shape holds more
  than a quarter of it (q, k and v came whole over ``model`` where it
  outnumbers the heads) -- at B = 8, whose rows divide over ``model``,
  and at 2 rows, which do not (C split by its columns, as the
  multi-pod mesh's 8 rows a data shard under 16 split it); so is the
  Mamba state (B, d_in, d_state) of jamba's prefill.
"""
import difflib
import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, T = 8, 16
MESHES = ("4,1", "2,2", "1,4")
#: the (1, 4) mesh again at 2 rows, which do not divide ``model``: the
#: xLSTM's C split by its columns (v's head dim)
FEW_ROWS = 2
#: the length of the (1, 4) cells, whose states are told apart by shape
#: from q and k (B, H, T, hd): the head dim is T
SPLIT_T = 24
#: (arch, MLSTM_CHUNK)
CELLS = (("xlstm-125m", None), ("xlstm-125m", 8),
         ("jamba-1.5-large-398b", None))
SHAPES = ("prefill_32k", "train_4k")
#: each process's limit in seconds (one mesh each, side by side: 60-90 s)
TIMEOUT_S = 600

RECORD = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.configs import shapes as ts
    from repro_torch.launch import dryrun, mesh as mesh_mod
    from repro_torch.models import ssm
    from repro_torch.runtime import train as train_mod

    job = json.loads(sys.argv[1])
    records, skip = [], [0]

    def paused(owner, name):
        fn = getattr(owner, name)

        def wrapped(*args, **kwargs):
            skip[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                skip[0] -= 1
        setattr(owner, name, wrapped)

    paused(train_mod, "adamw_update")

    def _own(t):
        # not an expansion without storage of its own (a scalar broadcast
        # over the batch: the loss's mean in the backward)
        return t.untyped_storage().nbytes() >= t.numel() * t.element_size()

    # DTensor wraps each op's local results with their specs (torch 2.11
    # and 2.13); the op is the last local one the meter saw
    last = [""]
    disp = type(DTensor._op_dispatcher)
    wrap = disp.wrap

    def wrapped(res, spec):
        if not skip[0]:
            specs = spec if isinstance(spec, (tuple, list)) else (spec,)
            got = res if isinstance(res, (tuple, list)) else (res,)
            records.extend((last[0], list(s.shape), list(t.shape))
                           for s, t in zip(specs, got)
                           if s is not None and isinstance(t, torch.Tensor)
                           and _own(t))
        return wrap(res, spec)
    disp.wrap = staticmethod(wrapped)

    FACTORIES = ("aten.zeros.", "aten.empty.", "aten.full.", "aten.ones.",
                 "aten.empty_strided.")
    track = dryrun.Meter._track

    def tracked(self, outs, ins, op):
        last[0] = op
        if not skip[0] and op.startswith(FACTORIES):
            records.extend((op, list(t.shape), list(t.shape)) for t in outs)
        return track(self, outs, ins, op)
    dryrun.Meter._track = tracked

    sizes = tuple(int(x) for x in job["mesh"].split(","))
    mesh = dryrun.fake_mesh(mesh_mod.MeshShape(("data", "model"), sizes))
    dryrun.set_dispatch(mesh, False)
    out = {}
    for arch, chunk in job["cells"]:
        ssm.MLSTM_CHUNK = chunk
        for shape in job["shapes"]:
            runs = []
            for batch in (job["B"], 2 * job["B"]):
                ts.SHAPES.clear()
                ts.SHAPES[shape] = ts.ShapeSpec(shape, shape.split("_")[0],
                                                job["T"], batch)
                records.clear()
                dryrun.count_cell(configs.get_smoke(arch), shape, mesh)
                runs.append(list(records))
            out[f"{arch}/{chunk}/{shape}"] = runs
    dryrun.release_fake_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def recorded():
    """Each mesh's records, its process started with the others."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    jobs = {(m, B): m for m in MESHES}
    jobs[("1,4", FEW_ROWS)] = "1,4"
    procs = {key: subprocess.Popen(
        [sys.executable, "-c", RECORD, json.dumps(
            {"mesh": m, "cells": CELLS, "shapes": SHAPES, "B": key[1],
             "T": SPLIT_T if m == "1,4" else T})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for key, m in jobs.items()}
    out = {}
    try:
        for m, p in procs.items():
            so, se = p.communicate(timeout=TIMEOUT_S)
            out[m] = (p.returncode, so, se)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


def _runs(recorded, mesh, arch, chunk, shape, batch=B):
    rc, so, se = recorded[(mesh, batch)]
    assert rc == 0, se[-4000:]
    return json.loads(so.strip().splitlines()[-1])[f"{arch}/{chunk}/{shape}"]


def _batch_dims(runs):
    """(op, global shape, local shape, batch dims) of each record at B,
    the batch dims confirmed by the aligned record at 2B."""
    at_b, at_2b = runs
    match = difflib.SequenceMatcher(None, [r[0] for r in at_b],
                                    [r[0] for r in at_2b], autojunk=False)
    out = []
    for a, b, n in match.get_matching_blocks():
        for (op, g, loc), (_, g2, _) in zip(at_b[a:a + n], at_2b[b:b + n]):
            dims = [i for i in (0, 1) if i < len(g) == len(g2)
                    and g[i] == B and g2[i] == 2 * B]
            if dims:
                out.append((op, g, loc, dims))
    return out


CASES = [pytest.param(m, a, c, s, id=f"{m}-{a}-{c}-{s}")
         for m in MESHES for a, c in CELLS for s in SHAPES]


@pytest.mark.parametrize("mesh,arch,chunk,shape",
                         [p for p in CASES if p.values[0] != "1,4"])
def test_no_rank_holds_more_rows_than_its_data_shard(recorded, mesh, arch,
                                                     chunk, shape):
    """No recorded tensor holds more than B / data rows of a batch dim."""
    data = int(mesh.split(",")[0])
    held = _batch_dims(_runs(recorded, mesh, arch, chunk, shape))
    assert held, "no batch dim recorded"
    over = [(op, g, loc) for op, g, loc, dims in held
            if any(loc[i] > B // data for i in dims)]
    assert not over, over[:10]


#: the xLSTM's cells at both batches, jamba's prefill at B (its train
#: step's Mamba gradients arrive partial where DTensor's own float32
#: ``mm`` rule meets a partial gradient: whole on each rank, torch 2.11
#: at B = 8 and 2.13 at 2 rows; ROADMAP fault 23)
SPLIT_CASES = [pytest.param(*p.values, batch, id=f"{p.id}-{batch}")
               for p in CASES if p.values[0] == "1,4"
               for batch in (B, FEW_ROWS)
               if p.values[1] == "xlstm-125m"
               or (batch == B and p.values[3] == "prefill_32k")]


@pytest.mark.parametrize("mesh,arch,chunk,shape,batch", SPLIT_CASES)
def test_recurrent_state_splits_over_model(recorded, mesh, arch, chunk,
                                           shape, batch):
    """No tensor of the state's global shape holds more than 1 / model of
    it on rank 0."""
    from repro_torch import configs

    cfg = configs.get_smoke(arch)
    if cfg.family == "ssm_xlstm":
        state = [batch, cfg.n_heads, cfg.hd, cfg.hd]
    else:
        state = [batch, cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state]
    model = int(mesh.split(",")[1])
    at_b, _ = _runs(recorded, mesh, arch, chunk, shape, batch)
    states = [(op, loc) for op, g, loc in at_b if g == state]
    assert states, f"no tensor of the state's shape {state}"
    whole = [(op, loc) for op, loc in states
             if len(loc) == len(state) and
             _numel(loc) * model > _numel(state)]
    assert not whole, whole[:10]


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n
