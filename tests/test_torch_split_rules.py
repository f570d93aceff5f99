"""How the sharded step splits attention and the products over a mesh,
so that no rank of the model axis does all of a layer's work.

Attention (``distributed.rules.attention_splits`` and
``local_attention``): every mesh dim that splits nothing else splits the
heads where they divide (each rank's q heads sharing one KV head picked
from whole k and v where the mesh dim is a multiple of the KV heads),
else the batch rows where they divide, and only else leaves a rank all
its rows and heads.  The choice is held in one process on placements
alone; and on a fake mesh of 8 ranks (a fake process group, meta
DTensors; in a subprocess, which the fake group must not outlive) by the
local shapes that ``local_attention`` gives the attention: each rank's
rows times heads equal its share, B Hq over the ranks.

Products (``rules._keep_column_split``, the card's ``mm.dtype``): on the
same fake mesh, a product one of whose operands is a partial sum over
``model`` where the other is split there -- an MLP's up projection, a
down projection, a weight's gradient -- does its share of the FLOPs on
each rank (``dryrun.Meter``), where DTensor alone gathers the split
operand and leaves every rank of ``model`` the whole product.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.distributed import rules

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
P, R = Partial(), Replicate()

#: (q placements, mesh sizes, B, Hq, Hkv) -> (splits, pick)
CASES = {
    # a model axis of 4 over 2 KV heads: the q heads, one KV head each
    "partial_pick": ((Shard(0), P), (2, 4), 8, 8, 2, ["rows", "heads"], 1),
    "replicated_pick": ((Shard(0), R), (2, 4), 8, 8, 2, ["rows", "heads"],
                        1),
    "heads_pick": ((Shard(0), Shard(1)), (2, 4), 8, 8, 2,
                   ["rows", "heads"], 1),
    # heads and KV heads both divide: split alike
    "partial_heads": ((Shard(0), P), (2, 4), 8, 8, 4, ["rows", "heads"],
                      None),
    # 6 heads over 3 KV heads divide neither a model axis of 4: the rows
    "partial_rows": ((Shard(0), P), (2, 4), 8, 6, 3, ["rows", "rows"], None),
    "replicated_rows": ((Shard(0), R), (2, 4), 8, 6, 3, ["rows", "rows"],
                        None),
    "heads_rows": ((Shard(0), Shard(1)), (2, 4), 8, 6, 3, ["rows", "rows"],
                   None),
    # the multi-pod layout: 16 heads over 8 KV heads on a model axis of
    # 16, whose 8 local rows do not divide
    "multipod": ((Shard(0), Shard(0), P), (2, 16, 16), 256, 16, 8,
                 ["rows", "rows", "heads"], 2),
    # neither heads nor rows divide: whole
    "whole": ((Shard(0), P), (2, 4), 2, 6, 3, ["rows", None], None),
    # a batch split that does not divide gives way to the heads
    "uneven_batch": ((Shard(0), Shard(0)), (2, 4), 4, 8, 4,
                     ["rows", "heads"], None),
    # a replicated mesh dim of one rank stays whole
    "one_rank": ((R, P), (1, 4), 8, 8, 4, [None, "heads"], None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_attention_splits_choice(name):
    q, sizes, B, Hq, Hkv, splits, pick = CASES[name]
    assert rules.attention_splits(q, sizes, B, Hq, Hkv) == (splits, pick)


def test_a_partial_mean_kv_is_not_picked():
    """Where k or v is a partial mean, whose gradient DTensor cannot give
    as the partial sum a pick leaves, the rows are split instead."""
    got = rules.attention_splits((Shard(0), P), (2, 4), 8, 8, 2,
                                 (Shard(0), Partial("avg")))
    assert got == (["rows", "rows"], None)


#: q, k and v placed on a fake (data, model) = (2, 4) mesh, attended by
#: ``local_attention``; each case's local q and k shapes on rank 0
LOCAL = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed import rules
    from repro_torch.launch import dryrun, mesh as mesh_mod

    mesh = dryrun.fake_mesh(mesh_mod.MeshShape(("data", "model"), (2, 4)))
    kinds = {"P": Partial(), "R": Replicate(), "S1": Shard(1)}
    out = {}
    for name, (kind, B, Hq, Hkv) in json.loads(sys.argv[1]).items():
        T, d = 16, 4
        seen = []

        def fn(q, k, v):
            seen.append([list(q.shape), list(k.shape)])
            return torch.zeros_like(q)

        def dt(H, kind):
            pl = (Shard(0), kinds[kind])
            local = [B // 2, H, T, d]
            if kind == "S1":
                local[1] //= 4
            return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                      pl, run_check=False,
                                      shape=torch.Size([B, H, T, d]),
                                      stride=(H * T * d, T * d, d, 1))

        kv = "R" if kind == "S1" and Hkv % 4 else kind
        o = rules.local_attention(fn, dt(Hq, kind), dt(Hkv, kv), dt(Hkv, kv))
        out[name] = {"local": seen[0], "out": list(o.shape)}
    def operand(shape, placements):
        local = list(shape)
        for n, p in zip((2, 4), placements):
            if p.is_shard():
                local[p.dim] //= n
        return DTensor.from_local(
            torch.empty(local, dtype=torch.bfloat16, device="meta"), mesh,
            placements, run_check=False, shape=torch.Size(shape),
            stride=(shape[1], 1))

    # (M, K) times (K, N): a partial input over model times a weight
    # split there by its columns (N > K) or its rows (N < K); and a
    # weight's gradient, the input's transpose split over model times a
    # partial output gradient
    for name, (M, K, N, pa, pb) in {
            "up": (64, 16, 64, (Shard(0), Partial()), (Replicate(), Shard(1))),
            "down": (64, 64, 16, (Shard(0), Partial()),
                     (Replicate(), Shard(0))),
            "weight_grad": (16, 64, 16, (Shard(1), Shard(0)),
                            (Shard(0), Partial()))}.items():
        a, b = operand((M, K), pa), operand((K, N), pb)
        meter = dryrun.Meter((a, b))
        with meter:
            torch.mm(a, b, out_dtype=torch.float32)
        out[name] = {"flops": meter.flops, "whole": 2 * M * K * N}
    dryrun.release_fake_group()
    print(json.dumps(out))
""")

#: case -> (q's placement on model, B, Hq, Hkv)
LOCAL_CASES = {
    "partial_pick": ("P", 8, 8, 2),
    "replicated_pick": ("R", 8, 8, 2),
    "heads_pick": ("S1", 8, 8, 2),
    "partial_rows": ("P", 8, 6, 3),
    "replicated_rows": ("R", 8, 6, 3),
}


@pytest.fixture(scope="module")
def local_shapes():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", LOCAL,
                          json.dumps(LOCAL_CASES)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(LOCAL_CASES))
def test_each_rank_attends_its_share(local_shapes, name):
    """On 8 ranks, each rank's q rows times heads are B Hq / 8; where
    the heads are split past the KV heads, the attention sees the one KV
    head its q heads share; the output keeps the global shape."""
    _, B, Hq, Hkv = LOCAL_CASES[name]
    (b, hq, _, _), (bk, hkv, _, _) = local_shapes[name]["local"]
    assert b * hq == B * Hq // 8
    assert bk == b
    if name.endswith("pick"):
        assert hkv == 1 and hq == Hq // 4
    else:
        assert hkv == Hkv and hq == Hq
    assert local_shapes[name]["out"] == [B, Hq, 16, 4]


@pytest.mark.parametrize("name", ["up", "down", "weight_grad"])
def test_partial_operand_product_does_its_share(local_shapes, name):
    """A partial operand over ``model`` times one split there (a weight,
    or in a weight's gradient the layer's input): each of the 8 ranks
    does an eighth of the product's FLOPs."""
    got = local_shapes[name]
    assert got["flops"] == got["whole"] // 8
