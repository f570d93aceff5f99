"""Multi-process checks of the port's sharded paths, for
``tests/test_torch_distributed.py``: one world of ``gloo`` ranks on the
CPU, started with ``torch.multiprocessing`` over a ``FileStore`` (no TCP
port), each part writing its results as JSON.

  python tests/torch_dist_worker.py PART OUT_DIR

PART is one of:
  sharded8  internlm2's smoke step over 8 ranks as a (4, 2) mesh, as
            the multi-pod layout (pod, data, model) = (2, 2, 2), and on a
            (2, 4) mesh at a batch of 4 (2 rows a data shard under
            ``model`` 4, the multi-pod train cells' layout in small),
            then with the card's product rules given to the CPU's mm and
            bmm (internlm2 and olmoe);
  sharded2  every other arch's smoke step over a (1, 2) mesh (``xla``
            attention), two through the flash path (``pallas``), and a
            TrainLoop resumed from a sharded checkpoint;
  sharded4  smoke steps over a (1, 4) mesh, whose model axis outnumbers
            the KV heads (2 in every arch below; whisper's 2 heads, the
            xLSTM's 2): the dense family through both attention paths,
            whisper, the MoE, the xLSTM and jamba;
  small4    smoke steps over a (1, 4) mesh at batches whose rows are
            fewer than the model axis or no multiple of it: each
            sharded4 case and qwen2-7b (the bias path) at 2 rows, and
            internlm2 at 3 and 6 (an uneven split of the rows);
  decode2   serving over a (1, 2) mesh: prefill and decode steps (a
            slot each, and one position a sequence) on a cache split by
            layer, by KV head, by sequence and by head dim, and by layer
            over one KV head (the holder attends), and a longer
            prefill on a cache split by layer, against the same calls
            unsharded and the reference's, with the heads each rank's
            attention was given; the vocab-parallel embedding lookup and
            its gradient against the whole table's;
  moe4      olmoe's smoke step over a (2, 2) mesh with the dry run's
            expert-parallel dispatch (``dryrun.set_dispatch``: two token
            groups over ``data``, the experts over ``model``), under
            both ``COMBINE_MODE``s, with the placements of the dispatch
            buffer and the expert outputs;
  collect4  ``pipeline_forward`` and ``compressed_psum`` over 4 ranks;
  single1   the sharded step on a 1 x 1 mesh against the unsharded one,
            bit for bit, and a sharded checkpoint restored unsharded;
  cuda1     on the card (nccl, one rank): the sharded step on a 1 x 1 mesh
            bit for bit the unsharded one, through the flash kernels on
            both routes (the float32 smoke model: fma; a bfloat16 one at
            head dim 64: wgmma).

The step cases of sharded8 and sharded2 start from the reference's state
and hold the sharded step against the reference's loss and gradients
too: the test module pickles them (numpy arrays; no JAX here) as
``OUT_DIR/ref_<arch>.pkl`` while the worlds run, and a case waits for
its file.  decode2's cases likewise start from the reference's params
and meet its logits and caches (``OUT_DIR/ref_decode_<split>.pkl``).

A world's clock starts when the files it reads (:data:`NEEDS`) are all
written, or at launch if it reads none: its ranks are stopped if it has
not finished within its part's :data:`DEADLINE_S` from then.  Rank 0's
JSON then carries the world's seconds (``seconds``: launch to inputs,
inputs to end).
"""
import contextlib
import datetime
import json
import os
import pickle
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import ARCH_IDS  # noqa: E402

#: each part's seconds from its inputs (or its launch) to its end before
#: it is stopped: at least four times the part's run from its inputs to
#: its end beside eight busy processes (``tools/fixture_timing.py worlds
#: --busy 8``: 98, 84, 44, 5, 20, 29, 34 and 61 s in the order below,
#: 211, 466, 285, 55, 95, 30, 35 and 419 s from the launch), and short
#: enough that the last inputs (written 391 s after the launch there)
#: plus a deadline stay well inside a tier-1 run's limit
DEADLINE_S = {"sharded8": 420, "sharded2": 600, "sharded4": 480,
              "decode2": 300, "moe4": 300, "collect4": 180, "single1": 240,
              "small4": 300, "cuda1": 300}
#: the longest a world waits for its inputs before it gives up
INPUTS_S = 1200
#: the world's output directory (checkpoints of the resume case go there)
OUT_DIR = None
WORLDS = {"sharded8": 8, "sharded2": 2, "sharded4": 4, "decode2": 2,
          "moe4": 4, "collect4": 4, "single1": 1, "small4": 4, "cuda1": 1}
#: decode2's caches: (layers, KV heads, slots) of the smoke internlm2
#: (head dim 16), and the dim of the stacked (L, B, T, Hkv, hd) cache the
#: reference's rule splits over ``model``: the layers where they number
#: the KV heads, the KV heads, else the longest axis (the last of equals)
DECODE2 = {"layer": (2, 2, 32, 0), "heads": (3, 2, 32, 3),
           "sequence": (3, 1, 32, 2), "layer_serial": (3, 1, 32, 0),
           "head_dim": (3, 1, 16, 4)}
#: decode2's caches placed by layer by hand, each with the case whose
#: model, cache and calls it shares, and so whose reference calls: the
#: reference's rule splits the layers only where they number the KV heads
#: and divide the model axis, so its layer splits always divide the
#: heads.  Over one KV head, which no split of the heads can share, each
#: layer's holder attends it (three layers: two on one rank, one on the
#: other)
BY_HAND = {"layer_serial": "sequence"}
#: (arch, attention impl) of the sharded4 part
SHARDED4 = (("internlm2-1.8b", "xla"), ("internlm2-1.8b", "pallas"),
            ("whisper-tiny", "xla"), ("dbrx-132b", "xla"),
            ("xlstm-125m", "xla"), ("jamba-1.5-large-398b", "xla"))
#: (arch, attention impl, batch) of the small4 part: every sharded4 case
#: and qwen2-7b at 2 rows over ``model`` 4, internlm2 at 3 and 6
SMALL4 = tuple((a, i, 2) for a, i in SHARDED4) + (
    ("qwen2-7b", "xla", 2), ("internlm2-1.8b", "xla", 3),
    ("internlm2-1.8b", "xla", 6))
#: the batch of sharded8's (2, 4) case
BATCH_2X4 = 4
#: the combine modes of the moe4 part
MOE4_COMBINE = ("gather", "scatter")
#: decode2's prefill-only cases, as DECODE2's, with their prompt length
#: (the layers must number the KV heads and not the batch, which the
#: reference's rule looks for first)
PREFILL2 = {"layer": (2, 2, 32, 0, 24)}


def ref_name(arch, B=8):
    """The name of the reference's step file of ``arch`` at a batch of
    ``B`` rows (:func:`_batch`'s 8 by default)."""
    return arch if B == 8 else f"{arch}_b{B}"


def ref_step(name):
    """``(arch, B)`` of a step file's :func:`ref_name`."""
    arch, _, b = name.rpartition("_b")
    return (arch, int(b)) if arch and b.isdigit() else (name, 8)


#: the reference files each part reads, ``OUT_DIR/ref_<name>.pkl``
NEEDS = {
    "sharded8": ("internlm2-1.8b", ref_name("internlm2-1.8b", BATCH_2X4),
                 "olmoe-1b-7b"),
    "sharded2": ARCH_IDS,
    "sharded4": tuple(dict.fromkeys(a for a, _ in SHARDED4)),
    "small4": tuple(dict.fromkeys(ref_name(a, B) for a, _, B in SMALL4)),
    "decode2": tuple(f"decode_{n}" for n in DECODE2 if n not in BY_HAND)
    + tuple(f"prefill_{n}" for n in PREFILL2),
    "moe4": tuple(f"olmoe-1b-7b_ep_{m}" for m in MOE4_COMBINE),
}


def _batch(cfg, B=8, T=16):
    """The reference's multi-device test batch (tokens = labels = 0..15 a
    row), with seeded frames for the encoder-decoder."""
    row = np.arange(T, dtype=np.int32)
    batch = {"tokens": np.tile(row[None], (B, 1)) % cfg.vocab,
             "labels": np.tile(row[None], (B, 1)) % cfg.vocab}
    if cfg.is_encdec:
        batch["frames"] = np.random.default_rng(1).normal(
            size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _placement(p) -> str:
    """``R``, ``S<dim>`` or ``P`` (reprs differ between torch versions)."""
    from torch.distributed.tensor import Replicate, Shard

    if isinstance(p, Shard):
        return f"S{p.dim}"
    return "R" if isinstance(p, Replicate) else "P"


def _rel_l2(got, want):
    den = want.float().norm().item()
    diff = (got.float() - want.float()).norm().item()
    return diff / den if den else diff


def _reference(arch):
    """The reference's state, loss and gradients for ``arch`` on
    :func:`_batch`, as the test module pickled them (numpy only); it
    writes them while the worlds run, so this waits for the file."""
    path = os.path.join(OUT_DIR, f"ref_{arch}.pkl")
    while not os.path.exists(path):
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def _grad_err(grads, want):
    """Each leaf's max |error| over the largest |gradient| of ``want``."""
    from repro_torch.tree import named_leaves

    got = dict((n, _full(g)) for n, g in named_leaves(grads))
    gmax = max(g.abs().max().item() for _, g in named_leaves(want))
    return {n: (got[n] - g).abs().max().item() / gmax
            for n, g in named_leaves(want)}


def _step_case(arch, mesh, impl, ref=None, B=8):
    """One smoke step of ``arch`` on :func:`_batch`'s ``B`` rows,
    unsharded and sharded on ``mesh``, both from the reference's initial
    state: the two losses and grad norms and the reference's loss (its
    file ``ref``, else :func:`ref_name`'s); each gradient leaf's max
    |error| over the tree's max |gradient|, of the sharded step against
    the unsharded one's and against the reference's
    ``jax.value_and_grad``; each param's relative L2 after the step
    (with whether it was all zeros before it); and the placements of
    the logits as they reach the loss and as it reads them."""
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import (build_model, params_from_jax,
                                    train_state_from_jax)
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import (make_loss_fn, make_train_step,
                                           value_and_grad)
    from repro_torch.tree import named_leaves

    cfg = configs.get_smoke(arch)
    ref = _reference(ref or ref_name(arch, B))
    model = build_model(cfg, attn_impl=impl, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, B).items()}
    single = train_state_from_jax(cfg, ref["state"], device="cpu")
    zero = {n: bool((p == 0).all()) for n, p in named_leaves(single["params"])}
    state = sharding.distribute_state(
        train_state_from_jax(cfg, ref["state"], device="cpu"), mesh)
    dbatch = sharding.distribute_batch(batch, mesh)
    loss_fn = make_loss_fn(model)
    _, g1 = value_and_grad(loss_fn, single["params"], batch)
    loss2, g2 = value_and_grad(loss_fn, state["params"], dbatch)
    grad_err = _grad_err(g2, g1)
    ref_grad_err = _grad_err(g2, params_from_jax(cfg, ref["grads"],
                                                 device="cpu"))
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    single, m1 = step(single, batch)
    with _recorded_attention() as attention, _recorded_logits() as logits:
        state, m2 = step(state, dbatch)
    p2 = dict((n, _full(p)) for n, p in named_leaves(state["params"]))
    return {
        "loss_single": m1["loss"].item(), "loss_sharded": m2["loss"].item(),
        "loss_ref": ref["loss"], "loss_sharded_grad": _full(loss2).item(),
        "ref_grad_err": ref_grad_err,
        "gnorm_single": m1["grad_norm"].item(),
        "gnorm_sharded": m2["grad_norm"].item(),
        "grad_err": grad_err,
        "param_rel_l2": {n: _rel_l2(p2[n], p)
                         for n, p in named_leaves(single["params"])},
        "zero_init": zero,
        "step": int(_full(state["step"])),
        "placements": {n: [_placement(x) for x in p.placements]
                       for n, p in named_leaves(state["params"])},
        "attention": attention,
        "logits": logits,
    }


@contextlib.contextmanager
def _recorded_logits():
    """While active, each call of ``rules.reduced_logits`` (the loss's
    DTensor logits) is recorded as the logits' placements and those the
    loss reads them in; yields the distinct records."""
    from repro_torch.distributed import rules

    seen, reduce = [], rules.reduced_logits

    def recorded(lf):
        out = reduce(lf)
        rec = [[_placement(x) for x in t.placements] for t in (lf, out)]
        if rec not in seen:
            seen.append(rec)
        return out

    rules.reduced_logits = recorded
    try:
        yield seen
    finally:
        rules.reduced_logits = reduce


@contextlib.contextmanager
def _recorded_attention():
    """While active, each call of ``rules.local_attention`` (the sharded
    step's attention) is recorded as the placements of its q, k and v,
    its (B, Hq, Hkv) and the split that ``rules.attention_plan`` chose
    on each mesh dim (``rows``, ``heads``, ``pick`` -- heads
    over whole k and v, one KV head picked -- or ``None``); yields the
    distinct records, in order."""
    from repro_torch.distributed import rules

    seen, attend = [], rules.local_attention

    def recorded(fn, q, k, v):
        splits, pick = rules.attention_plan(q, k, v)
        rec = {"q": [_placement(x) for x in q.placements],
               "kv": [[_placement(x) for x in t.placements] for t in (k, v)],
               "shape": [q.shape[0], q.shape[1], k.shape[1]],
               "splits": ["pick" if i == pick else c
                          for i, c in enumerate(splits)]}
        if rec not in seen:
            seen.append(rec)
        return attend(fn, q, k, v)

    rules.local_attention = recorded
    try:
        yield seen
    finally:
        rules.local_attention = attend


def part_sharded8(rank, out):
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, device="cpu")
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    out["internlm2-1.8b"] = _step_case("internlm2-1.8b", mesh, "xla")
    # the multi-pod mesh's layout, (pod, data, model) = (2, 2, 2): the
    # embedding lookup with the batch over pod and data
    from torch.distributed.device_mesh import init_device_mesh

    mesh3 = init_device_mesh("cpu", (2, 2, 2),
                             mesh_dim_names=("pod", "data", "model"))
    out["internlm2-1.8b/pod_data_model"] = _step_case("internlm2-1.8b",
                                                      mesh3, "xla")
    # 2 rows a data shard under a model axis of 4
    mesh24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out["internlm2-1.8b/2x4"] = _step_case("internlm2-1.8b", mesh24, "xla",
                                           B=BATCH_2X4)
    # the card's product rules (mm.dtype, bmm.dtype, which the CPU has no
    # kernel for) given to the CPU's mm and bmm, which matmul_f32 reaches
    from repro_torch.distributed import rules
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.aten.mm.default)(rules._mm)
    register_sharding(torch.ops.aten.bmm.default)(rules._bmm)
    rules._register_column_split(torch.ops.aten.mm.default)
    for arch in ("internlm2-1.8b", "olmoe-1b-7b"):
        out[f"{arch}/mm_dtype_rules"] = _step_case(arch, mesh, "xla")
    # a serving cache's placements: batch 8 over data, kv heads over model
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import build_model

    cfg = configs.get_smoke("internlm2-1.8b")
    cache = build_model(cfg, device="meta").init_cache(8, 32)
    out["cache_placements"] = {
        k: [_placement(x) for x in v] for k, v in
        sharding.cache_shardings(cache, cfg, mesh, batch=8).items()}


def part_sharded2(rank, out):
    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, device="cpu")
    for arch in configs.ARCH_IDS:
        if arch != "internlm2-1.8b":
            out[f"{arch}/xla"] = _step_case(arch, mesh, "xla")
    for arch in ("internlm2-1.8b", "whisper-tiny"):
        out[f"{arch}/pallas"] = _step_case(arch, mesh, "pallas")
    out["resume"] = _resume_case(mesh)


def part_sharded4(rank, out):
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(4, device="cpu")
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    for arch, impl in SHARDED4:
        out[f"{arch}/{impl}"] = _step_case(arch, mesh, impl)


def part_small4(rank, out):
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(4, device="cpu")
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    for arch, impl, B in SMALL4:
        out[f"{arch}/{impl}/{B}"] = _step_case(arch, mesh, impl, B=B)


def _record_rows(moe, seen):
    """Wrap ``moe``'s row ops so that each forward call on DTensors
    records its (G, S, d) side's length, its (G, J, d) side's and the
    placements of both, as ``(op, S, J, S side, J side)``."""
    gather, scatter = moe.gather_rows, moe.scatter_add_rows

    def pl(t):
        return [_placement(p) for p in getattr(t, "placements", ())]

    def gather_rows(src, index):
        out = gather(src, index)
        if torch.is_grad_enabled() and pl(out):
            seen.append(("gather", src.shape[1], index.shape[1], pl(src),
                         pl(out)))
        return out

    def scatter_add_rows(src, index, like):
        out = scatter(src, index, like)
        if torch.is_grad_enabled() and pl(out):
            seen.append(("scatter", like.shape[1], index.shape[1], pl(out),
                         pl(src)))
        return out

    moe.gather_rows, moe.scatter_add_rows = gather_rows, scatter_add_rows
    return gather, scatter


def part_moe4(rank, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import moe

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    cfg = configs.get_smoke("olmoe-1b-7b")
    m = cfg.moe
    # the expert side's length, E C: the capacity of the batch's N tokens
    # over two groups
    N = np.prod(_batch(cfg)["tokens"].shape)
    cap = max(int(np.ceil(N * m.top_k / m.n_experts * m.capacity_factor)), 8)
    slots = m.n_experts * max(8, cap // 2)
    for mode in MOE4_COMBINE:
        dryrun.set_dispatch(mesh, False)
        moe.COMBINE_MODE = mode
        seen = []
        saved = _record_rows(moe, seen)
        try:
            case = _step_case("olmoe-1b-7b", mesh, "xla",
                              ref=f"olmoe-1b-7b_ep_{mode}")
        finally:
            moe.gather_rows, moe.scatter_add_rows = saved
            moe.set_ep_sharding(None, None)
            moe.COMBINE_MODE = "gather"
        case["rows"] = seen
        case["slots"] = int(slots)
        out[mode] = case


#: decode2's batch and prompt length
DECODE_B, DECODE_P = 4, 8


def decode_inputs(vocab, L, prompt=DECODE_P):
    """decode2's tokens, (B, prompt + 4) from a seed, and the positions a
    sequence of its per-slot steps (across both ranks' slots of an
    ``L``-slot cache)."""
    B, P = DECODE_B, prompt
    tokens = np.random.default_rng(2).integers(0, vocab, (B, P + 4))
    return tokens, np.array([P + 2, P + 5, L // 2 + 1, L - 2])


def decode_calls(model, params, cache, tokens, at, *, tensor, scalar=int,
                 prompt=DECODE_P, steps=True):
    """decode2's serving calls on a model of either package: a prefill of
    ``prompt`` tokens, then (with ``steps``) two decode steps at one
    position and two at a position a sequence (``at``, then ``at +
    1``).  ``tensor`` makes the array arguments, ``scalar`` the one
    positions.  The logits of each call and the last cache."""
    P = prompt
    logits, cache = model.prefill(params, {"tokens": tensor(tokens[:, :P])},
                                  cache)
    out = [logits]
    for i in range(2 * steps):
        logits, cache = model.decode_step(params, tensor(tokens[:, P + i]),
                                          cache, scalar(P + i))
        out.append(logits)
    for i in range(2 * steps):
        logits, cache = model.decode_step(params, tensor(tokens[:, P + 2 + i]),
                                          cache, tensor(at + i))
        out.append(logits)
    return out, cache


def _decode_case(mesh, name, n_layers, n_kv_heads, L, split_dim,
                 prompt=DECODE_P, *, steps=True):
    """The smoke internlm2 with ``n_layers`` and ``n_kv_heads``, from the
    reference's params: :func:`decode_calls` into an ``L``-slot cache
    unsharded and sharded on ``mesh``.  The logits' max |difference| over
    their max |value| and the cache's, of the sharded calls against the
    unsharded ones and of both against the reference's same calls; and
    every rank's attention calls in the sharded run, as the (q heads, KV
    heads) that each was given."""
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.kernels.attention import ops
    from repro_torch.models import build_model, params_from_jax

    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                              n_layers=n_layers, n_kv_heads=n_kv_heads)
    ref = _reference(
        f"{'decode' if steps else 'prefill'}_{BY_HAND.get(name, name)}")
    model = build_model(cfg, attn_impl="xla", device="cpu")
    params = params_from_jax(cfg, ref["params"], device="cpu")
    B = DECODE_B
    tokens, at = decode_inputs(cfg.vocab, L, prompt)
    pl = sharding.cache_shardings(model.init_cache(B, L), cfg, mesh, batch=B)
    if name in BY_HAND:
        # DTensor's own placement: ``sharding.place`` refuses a split
        # that does not divide
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)

        pl = {k: (Replicate(), Shard(0)) for k in pl}
        cache = {k: distribute_tensor(v, mesh, pl[k])
                 for k, v in model.init_cache(B, L).items()}
    else:
        cache = sharding.place(model.init_cache(B, L), pl, mesh)
    placed = sharding.place(params, sharding.param_shardings(params, mesh),
                            mesh)
    attend, calls = ops._cache_attention, []

    def counted(q, k, v, ck, cv, *args, **kwargs):
        calls.append((q.shape[2], ck.shape[2]))
        return attend(q, k, v, ck, cv, *args, **kwargs)

    runs = {}
    for run, p, cache in (
            ("single", params, model.init_cache(B, L)),
            ("sharded", placed, cache)):
        ops._cache_attention = counted if run == "sharded" else attend
        try:
            with torch.no_grad(), implicit_replication():
                out, cache = decode_calls(model, p, cache, tokens, at,
                                          tensor=torch.as_tensor,
                                          prompt=prompt, steps=steps)
        finally:
            ops._cache_attention = attend
        runs[run] = ([_full(x) for x in out],
                     {k: _full(v) for k, v in cache.items()})
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, calls)
    runs["ref"] = ([torch.as_tensor(x) for x in ref["logits"]],
                   {k: torch.as_tensor(v) for k, v in ref["cache"].items()})

    def err(got, want):
        (g, gc), (w, wc) = runs[got], runs[want]
        return {"logits": [(a - b).abs().max().item() / b.abs().max().item()
                           for a, b in zip(g, w)],
                "cache": max((gc[k].float() - wc[k].float()).abs().max().item()
                             / wc[k].float().abs().max().item() for k in wc)}

    return {
        "placements": [_placement(x) for x in pl["k"]],
        "split_dim": split_dim,
        "heads": (cfg.n_heads, n_kv_heads),
        "layers": n_layers,
        "attention": ranks,
        "sharded": err("sharded", "single"),
        "ref_single": err("single", "ref"),
        "ref_sharded": err("sharded", "ref"),
    }


def _lookup_case(mesh):
    """``models.layers.embedding`` of a vocab-split table (its DTensor
    rules) against the whole table's ``table[tokens]``: the rows and the
    table's gradient, bit for bit (a row and zeros; each row's gradient
    summed on its rank in the same order)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(3)
    table = torch.randn(128, 16, generator=gen)
    tokens = torch.randint(0, 128, (4, 12), generator=gen)
    tokens[0, :6] = 5                      # a repeated row
    grad = torch.randn(4, 12, 16, generator=gen)
    w = table.clone().requires_grad_(True)
    want = w[tokens]
    (want_g,) = torch.autograd.grad(want, w, grad)
    wd = sharding.distribute(table, mesh, (Replicate(), Shard(0)))
    wd.requires_grad_(True)
    got = layers.embedding(wd, tokens)
    (got_g,) = torch.autograd.grad(got, wd, sharding.distribute(
        grad, mesh, (Replicate(), Replicate())))
    return {"rows_equal": torch.equal(_full(got), want),
            "out_placements": [_placement(x) for x in got.placements],
            "grad_equal": torch.equal(_full(got_g), want_g),
            "grad_placements": [_placement(x) for x in got_g.placements]}


def part_decode2(rank, out):
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, device="cpu")
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    for name, case in DECODE2.items():
        out[name] = _decode_case(mesh, name, *case)
    for name, case in PREFILL2.items():
        out[f"prefill_{name}"] = _decode_case(mesh, name, *case, steps=False)
    out["lookup"] = _lookup_case(mesh)


def _resume_case(mesh):
    """TrainLoop on ``mesh``, checkpointing every step: 3 steps straight
    against 2, a restore into a fresh sharded state, and 1 more."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import TokenStream
    from repro_torch.distributed import sharding
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import (LoopConfig, TrainLoop,
                                           init_train_state, make_train_step)
    from repro_torch.tree import named_leaves

    cfg = configs.get_smoke("internlm2-1.8b")
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=3))

    def fresh():
        return sharding.distribute_state(
            init_train_state(model, torch.Generator().manual_seed(0)), mesh)

    def run(state, ckpt_dir, start, total):
        stream = TokenStream(vocab=cfg.vocab, batch=4, seq_len=16,
                             start_step=start)
        data = (sharding.distribute_batch(b, mesh) for b in stream)
        return TrainLoop(step, state, data, cfg=LoopConfig(
            total_steps=total, checkpoint_every=1),
            checkpointer=CheckpointManager(ckpt_dir)).run()

    whole = run(fresh(), os.path.join(OUT_DIR, "resume_whole"), 0, 3)
    split_dir = os.path.join(OUT_DIR, "resume_split")
    run(fresh(), split_dir, 0, 2)
    state = CheckpointManager(split_dir).restore(fresh())
    resumed_at = int(_full(state["step"]))
    split = run(state, split_dir, resumed_at, 3)
    got = dict((n, _full(v)) for n, v in named_leaves(split))
    return {"resumed_at": resumed_at, "steps": int(_full(split["step"])),
            "unequal_leaves": [n for n, v in named_leaves(whole)
                               if not torch.equal(got[n], _full(v))],
            "leaves": len(got)}


def part_collect4(rank, out):
    from repro_torch.distributed import compression, pipeline

    # pipeline: the reference's S 4, L 4, mb 2, M 4, d 8
    S, mb, M, d = 4, 2, 4, 8
    rng = np.random.default_rng(1)
    w = torch.as_tensor(rng.normal(size=(S, d, d)).astype(np.float32) * 0.3)
    x = torch.as_tensor(rng.normal(size=(M, mb, d)).astype(np.float32))
    got = pipeline.pipeline_forward(lambda wi, h: torch.tanh(h @ wi), w, x)
    want = x
    for s in range(S):
        want = torch.tanh(want @ w[s])
    out["pp_err"] = (got - want).abs().max().item()
    out["pp_out"] = got.flatten().tolist()
    xs = pipeline.microbatch(torch.arange(24.0).reshape(8, 3), 4)
    out["microbatch_roundtrip"] = bool(torch.equal(
        pipeline.unmicrobatch(xs), torch.arange(24.0).reshape(8, 3)))

    # compressed psum of row `rank` of a (4, 64) array
    g = np.random.default_rng(3).normal(size=(4, 64)).astype(np.float32) * 0.01
    mean, new_err = compression.compressed_psum(
        torch.as_tensor(g[rank]), torch.zeros(64))
    out["psum_err"] = float(np.abs(mean.numpy() - g.mean(axis=0)).max())
    out["mean_hex"] = mean.numpy().tobytes().hex()
    out["err_hex"] = new_err.numpy().tobytes().hex()
    # every rank's mean, to show they agree
    means = [torch.zeros(64) for _ in range(4)]
    dist.all_gather(means, mean)
    out["ranks_agree"] = all(torch.equal(m, mean) for m in means)
    # the tree form: each leaf as compressed_psum alone
    tree = {"a": torch.as_tensor(g[rank]), "b": [torch.as_tensor(g[rank, :8])]}
    errs = compression.init_error_feedback(tree)
    tm, te = compression.tree_compressed_psum(tree, errs)
    m_b, e_b = compression.compressed_psum(tree["b"][0], errs["b"][0])
    out["tree_psum_equal"] = (torch.equal(tm["a"], mean) and torch.equal(
        te["a"], new_err) and torch.equal(tm["b"][0], m_b)
        and torch.equal(te["b"][0], e_b))


def part_single1(rank, out):
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import init_train_state, make_train_step
    from repro_torch.tree import named_leaves

    mesh = make_local_mesh(1, device="cpu")
    cfg = configs.get_smoke("internlm2-1.8b")
    for impl in ("pallas", "xla"):
        model = build_model(cfg, attn_impl=impl, device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=0))
        single = init_train_state(model, torch.Generator().manual_seed(0))
        state = sharding.distribute_state(
            init_train_state(model, torch.Generator().manual_seed(0)), mesh)
        for _ in range(2):
            single, m1 = step(single, batch)
            state, m2 = step(state, sharding.distribute_batch(batch, mesh))
        got = dict((n, _full(v)) for n, v in named_leaves(state))
        out[impl] = {
            "loss_equal": m1["loss"].item() == m2["loss"].item(),
            "gnorm_equal": m1["grad_norm"].item() == m2["grad_norm"].item(),
            "unequal_leaves": [n for n, v in named_leaves(single)
                               if not torch.equal(got[n], v)],
            "leaves": len(got),
        }
    # a DTensor never reaches the kernels' launch checks
    from torch.distributed.tensor import Replicate

    from repro_torch.kernels.attention import attention

    q = DTensor.from_local(torch.zeros(2, 8, 16), mesh, (Replicate(),) * 2)
    try:
        attention._check_tensors(q)
        out["kernel_refuses_dtensor"] = False
    except TypeError:
        out["kernel_refuses_dtensor"] = True
    # a sharded checkpoint restores into an unsharded state, and back
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(state, step=2)
        plain = mgr.restore(init_train_state(
            model, torch.Generator().manual_seed(1)))
        again = mgr.restore(state)
    out["restore_plain_equal"] = all(
        torch.equal(plain_v, got[n]) for n, plain_v in named_leaves(plain))
    out["restore_sharded_equal"] = all(
        torch.equal(_full(v), got[n]) for n, v in named_leaves(again))
    out["restore_sharded_placements"] = all(
        tuple(v.placements) == tuple(w.placements) for (_, v), (_, w) in
        zip(named_leaves(again), named_leaves(state)))


def part_cuda1(rank, out):
    import dataclasses

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.kernels.attention import attention
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import init_train_state, make_train_step
    from repro_torch.tree import named_leaves

    dev = torch.device("cuda", 0)
    mesh = make_local_mesh(1, device=dev)
    smoke = configs.get_smoke("internlm2-1.8b")
    cases = {"fma": smoke, "wgmma": dataclasses.replace(
        smoke, d_model=256, n_heads=4, n_kv_heads=2, param_dtype="bfloat16",
        compute_dtype="bfloat16")}
    for route, cfg in cases.items():
        model = build_model(cfg, device=dev)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in _batch(cfg, B=2, T=128).items()}
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=0))
        gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
        single = init_train_state(model, gen())
        state = sharding.distribute_state(init_train_state(model, gen()), mesh)
        counts = []
        for st in ("single", "sharded"):
            attention.flash_attention_bwd.launches_by_route[route] = 0
            for _ in range(2):
                if st == "single":
                    single, m1 = step(single, batch)
                else:
                    state, m2 = step(state, sharding.distribute_batch(
                        batch, mesh))
            counts.append(attention.flash_attention_bwd.launches_by_route[
                route])
        got = dict((n, _full(v)) for n, v in named_leaves(state))
        out[route] = {
            "loss_equal": m1["loss"].item() == m2["loss"].item(),
            "gnorm_equal": m1["grad_norm"].item() == m2["grad_norm"].item(),
            "unequal_leaves": [n for n, v in named_leaves(single)
                               if not torch.equal(got[n], v)],
            "bwd_launches": counts,
        }


def _rank_main(rank, world, part, out_dir):
    global OUT_DIR
    OUT_DIR = out_dir
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, f"{part}.store"), world)
    backend = "nccl" if part.startswith("cuda") else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=INPUTS_S + DEADLINE_S[part]))
    out = {}
    try:
        globals()[f"part_{part}"](rank, out)
    except Exception:
        out["error"] = traceback.format_exc()[-4000:]
    if rank == 0 or "error" in out:
        name = f"{part}.json" if rank == 0 else f"{part}.rank{rank}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


def main(part: str, out_dir: str) -> int:
    world = WORLDS[part]
    store = os.path.join(out_dir, f"{part}.store")
    if os.path.exists(store):   # a FileStore must start empty
        os.remove(store)
    start = time.monotonic()
    ctx = mp.start_processes(_rank_main, args=(world, part, out_dir),
                             nprocs=world, join=False, start_method="spawn")
    inputs = [os.path.join(out_dir, f"ref_{n}.pkl")
              for n in NEEDS.get(part, ())]
    ready = None
    try:
        while not ctx.join(timeout=1):
            now = time.monotonic()
            if ready is None and all(map(os.path.exists, inputs)):
                ready = now
            if ready is None and now - start > INPUTS_S:
                raise TimeoutError(f"{part}: inputs not written in "
                                   f"{INPUTS_S} s")
            if ready is not None and now - ready > DEADLINE_S[part]:
                raise TimeoutError(f"{part}: not done in {DEADLINE_S[part]} s "
                                   "from its inputs")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    end = time.monotonic()
    path = os.path.join(out_dir, f"{part}.json")
    with open(path) as f:
        out = json.load(f)
    ready = end if ready is None else ready
    out["seconds"] = {"inputs": ready - start, "run": end - ready}
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
