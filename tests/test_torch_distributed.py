"""The port's distribution layer held against the reference's on the CPU:
int8 compression bit for bit, and the sharded train step, the pipeline
schedule and the compressed all-reduce across ``gloo`` ranks.

The multi-rank parts run in ``tests/torch_dist_worker.py``, one world
of ranks per part (over a ``FileStore``, no TCP port), all started side
by side by one module fixture, which then writes the reference's files
the worlds read; each part's results are a module fixture of their own,
so a world that fails or outruns its deadline (the worker's
``DEADLINE_S``, counted from its inputs) errors only its own tests.
Bounds, as
the reference's ``tests/test_distributed.py::test_multidevice_semantics``
holds its own: |loss single - loss sharded| < 1e-3, ``pp_err`` < 1e-5,
``psum_err`` < 2e-4.  Beyond it:

* every gradient leaf of the sharded step within 1e-4 x the tree's
  largest |gradient| of the unsharded one (float32 summed in another
  order: partial sums over ranks);
* each param after one AdamW step within 1e-5 relative L2 of the
  unsharded step's -- every param that is not all zeros before the step.
  A zero-initialized leaf (a bias) is after one step Adam's first update
  itself, -lr g / (|g| + eps), whose entries with |g| near eps carry
  the gradient's rounding whole (xlstm's input-gate bias has gradients
  of 1e-9 of the tree's largest); its gradient is held by the bound
  above;
* on a mesh of one rank the sharded step is bitwise the unsharded one;
* the compressed mean bitwise the reference's ``compressed_psum`` on the
  same array over 4 forced host devices.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from conftest import subprocess_env
from repro.distributed import compression as r_compression
from repro_torch import configs
from repro_torch.distributed import compression

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT_S = 300
#: a part's wait beyond its world's own deadline
MARGIN_S = 60
LOSS_ATOL, GRAD_FRAC, PARAM_REL_L2 = 1e-3, 1e-4, 1e-5


PARTS = ("sharded8", "sharded2", "sharded4", "decode2", "moe4", "collect4",
         "single1", "small4")


def _reference_groups():
    """The reference files the worlds read, in the order they are written
    (decode2's and moe4's first, then sharded8's, sharded4's, small4's
    and the rest), as (name, function of the output directory)."""
    writers = {f"olmoe-1b-7b_ep_{mode}": lambda d, m=mode: _write_moe(d, m)
               for mode in worker.MOE4_COMBINE}
    for kind, name, *rest in [
            ("decode", name, case, worker.DECODE_P, True)
            for name, case in worker.DECODE2.items()
            if name not in worker.BY_HAND] + [
            ("prefill", name, case[:4], case[4], False)
            for name, case in worker.PREFILL2.items()]:
        writers[f"{kind}_{name}"] = (
            lambda d, c=(kind, name, *rest): _write_decode(d, *c))
    order = [n for part in ("decode2", "moe4", "sharded8", "sharded4",
                            "small4", "sharded2") for n in worker.NEEDS[part]]
    return [(n, writers.get(n, lambda d, a=n: _write_step(
        d, *worker.ref_step(a), name=a))) for n in dict.fromkeys(order)]


def _write_step(out_dir, arch, B=8, name=None):
    """The reference's initial state of ``arch`` at smoke (seed 0,
    ``attn_impl="xla"``) and its loss and gradients on the worker's batch
    of ``B`` rows (``jax.value_and_grad``), pickled as numpy for the
    worker."""
    from repro import configs as r_configs
    from repro.models import build_model as r_build_model
    from repro.runtime import train as r_train

    r_model = r_build_model(r_configs.get_smoke(arch), attn_impl="xla")
    state = r_train.init_train_state(r_model, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in
             worker._batch(configs.get_smoke(arch), B).items()}
    loss, grads = jax.value_and_grad(r_train.make_loss_fn(r_model))(
        state["params"], batch)
    _pickle(out_dir, name or arch, {"state": jax.device_get(state),
                                    "loss": float(loss),
                                    "grads": jax.device_get(grads)})


def _write_moe(out_dir, mode):
    """moe4's: olmoe with two token groups (the dry run's dispatch on a
    (2, 2) mesh; the reference drops its buffer constraint with no mesh),
    under combine ``mode``."""
    from repro.models import moe as r_moe

    r_moe.set_ep_sharding("model", ("data",), num_groups=2)
    r_moe.COMBINE_MODE = mode
    try:
        _write_step(out_dir, "olmoe-1b-7b", name=f"olmoe-1b-7b_ep_{mode}")
    finally:
        r_moe.set_ep_sharding(None, None)
        r_moe.COMBINE_MODE = "gather"


def _write_decode(out_dir, kind, name, case, prompt, steps):
    """decode2's: the reference's params (seed 0) and its serving calls'
    logits and last cache for one cache of the part."""
    from repro import configs as r_configs
    from repro.models import build_model as r_build_model

    n_layers, n_kv_heads, L, _ = case
    cfg = dataclasses.replace(r_configs.get_smoke("internlm2-1.8b"),
                              n_layers=n_layers, n_kv_heads=n_kv_heads)
    r_model = r_build_model(cfg, attn_impl="xla")
    params = r_model.init(jax.random.PRNGKey(0))
    tokens, at = worker.decode_inputs(cfg.vocab, L, prompt)
    logits, cache = worker.decode_calls(
        r_model, params, r_model.init_cache(worker.DECODE_B, L), tokens,
        at, tensor=jnp.asarray, scalar=jnp.int32, prompt=prompt,
        steps=steps)
    _pickle(out_dir, f"{kind}_{name}", {
        "params": jax.tree_util.tree_map(np.asarray, params),
        "logits": [np.asarray(x) for x in logits],
        "cache": {k: np.asarray(v) for k, v in cache.items()}})


def _pickle(out_dir, name, obj):
    path = os.path.join(out_dir, f"ref_{name}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)   # whole when a worker sees it


class _Worlds:
    """The worlds, started side by side, and the reference files written
    meanwhile (:func:`_reference_groups`): when each was written, or the
    error that stopped it."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        self.started = time.monotonic()
        self.logs = {part: open(os.path.join(out_dir, f"{part}.log"), "w+")
                     for part in PARTS}
        self.procs = {part: subprocess.Popen(
            [sys.executable, WORKER, part, str(out_dir)],
            stdout=self.logs[part], stderr=subprocess.STDOUT)
            for part in PARTS}
        self.written, self.failed = {}, {}
        for name, write in _reference_groups():
            try:
                write(out_dir)
                self.written[name] = time.monotonic()
            except Exception as e:      # only the parts that read it fail
                self.failed[name] = repr(e)

    def result(self, part):
        """``part``'s results; raises if a reference it reads failed, or
        if its world failed or outran its deadline.  The wait ends
        :data:`MARGIN_S` after the world's own deadline, so that the
        world's message is what a failure shows."""
        p, log = self.procs[part], self.logs[part]
        try:
            needs = worker.NEEDS.get(part, ())
            bad = {n: self.failed[n] for n in needs if n in self.failed}
            assert not bad, f"{part}: its reference failed: {bad}"
            ready = max([self.started] + [self.written[n] for n in needs])
            limit = ready + worker.DEADLINE_S[part] + MARGIN_S
            p.wait(timeout=max(limit - time.monotonic(), 1))
        finally:
            if p.poll() is None:
                p.kill()
        log.seek(0)
        assert p.returncode == 0, log.read()[-4000:]
        with open(os.path.join(self.out_dir, f"{part}.json")) as f:
            out = json.load(f)
        assert "error" not in out, out["error"]
        return out

    def close(self):
        for part, p in self.procs.items():
            if p.poll() is None:
                p.kill()
            self.logs[part].close()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = _Worlds(tmp_path_factory.mktemp("worlds"))
    yield w
    w.close()


def _part(part):
    """A module fixture of ``part``'s results alone: a world that fails
    errors the tests that read it and no others."""
    @pytest.fixture(scope="module", name=part)
    def fixture(worlds):
        return worlds.result(part)
    return fixture


sharded8, sharded2, sharded4, decode2, moe4, collect4, single1, small4 = map(
    _part, PARTS)


def _check_step(r):
    assert abs(r["loss_single"] - r["loss_sharded"]) < LOSS_ATOL
    # the reference's jax.value_and_grad on the same state and batch
    assert abs(r["loss_sharded"] - r["loss_ref"]) < LOSS_ATOL
    assert abs(r["loss_sharded_grad"] - r["loss_ref"]) < LOSS_ATOL
    bad = {n: e for n, e in r["ref_grad_err"].items() if not e <= GRAD_FRAC}
    assert not bad, bad
    np.testing.assert_allclose(r["gnorm_sharded"], r["gnorm_single"],
                               rtol=1e-5)
    bad = {n: e for n, e in r["grad_err"].items() if not e <= GRAD_FRAC}
    assert not bad, bad
    bad = {n: e for n, e in r["param_rel_l2"].items()
           if not r["zero_init"][n] and not e <= PARAM_REL_L2}
    assert not bad, bad
    assert r["step"] == 1


# -- compression, in one process ------------------------------------------------------

def _bits(t):
    return np.asarray(t).tobytes()


def test_quantize_bitwise_reference(rng):
    for scale in (1.0, 1e-3, 1e-30, 0.0):
        g = (rng.normal(size=(257,)) * scale).astype(np.float32)
        q, s = compression.quantize(torch.as_tensor(g))
        rq, rs = r_compression.quantize(jnp.asarray(g))
        assert q.dtype == torch.int8
        assert _bits(q.numpy()) == _bits(rq) and _bits(s.numpy()) == _bits(rs)
        assert _bits(compression.dequantize(q, s).numpy()) == _bits(
            r_compression.dequantize(rq, rs))


def test_quantize_rounds_half_to_even():
    # 127 * (k + 0.5) / 127.5 ... exact halves of the scale: g = 2.5 s
    g = torch.tensor([127.0, 2.5, -2.5, 0.5, 1.5], dtype=torch.float32)
    q, s = compression.quantize(g)
    assert s.item() == 1.0 and q.tolist() == [127, 2, -2, 0, 2]
    rq, _ = r_compression.quantize(jnp.asarray(g.numpy()))
    assert q.tolist() == np.asarray(rq).tolist()


def test_compress_with_feedback_bitwise_reference(rng):
    g = rng.normal(size=(4, 33)).astype(np.float32) * 0.01
    err = rng.normal(size=(4, 33)).astype(np.float32) * 1e-4
    got = compression.compress_with_feedback(torch.as_tensor(g),
                                             torch.as_tensor(err))
    want = r_compression.compress_with_feedback(jnp.asarray(g),
                                                jnp.asarray(err))
    for a, b in zip(got, want):
        assert _bits(a.numpy()) == _bits(b)


def test_quantize_roundtrip_bound(rng):
    g = rng.normal(size=(128,)).astype(np.float32)
    q, scale = compression.quantize(torch.as_tensor(g))
    back = compression.dequantize(q, scale).numpy()
    assert np.abs(back - g).max() <= float(scale) * 0.5 + 1e-7


def test_error_feedback_reduces_bias(rng):
    """With error feedback the time-averaged quantized gradient converges
    to the true mean (unbiasedness over steps)."""
    g = torch.as_tensor(rng.normal(size=(256,)).astype(np.float32) * 0.01)
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    n = 50
    for _ in range(n):
        q, s, err = compression.compress_with_feedback(g, err)
        acc += compression.dequantize(q, s)
    assert (acc / n - g).abs().max().item() < 1e-4


def test_init_error_feedback_and_tree_shapes():
    like = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
            "b": [torch.zeros(5)]}
    errs = compression.init_error_feedback(like)
    assert errs["a"].dtype == torch.float32 and errs["a"].shape == (3, 4)
    assert errs["b"][0].shape == (5,) and not errs["b"][0].any()


# -- multi-rank -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b"])
def test_sharded_step_4x2_through_the_cards_product_rules(sharded8, arch):
    """The rules registered for the card's ``mm.dtype``/``bmm.dtype``,
    given to the CPU's ``mm``/``bmm``, over a (4, 2) mesh."""
    _check_step(sharded8[f"{arch}/mm_dtype_rules"])


def test_sharded_step_4x2_matches_single(sharded8):
    r = sharded8
    assert r["mesh"] == {"data": 4, "model": 2}
    step = r["internlm2-1.8b"]
    _check_step(step)
    # the rules placed the params: heads and ffn over model, vocab too
    pl = step["placements"]
    assert pl["blocks.attn.wq.w"] == ["R", "S2"]
    assert pl["embed.tok"] == ["R", "S0"]
    assert pl["blocks.ln1.scale"] == ["R", "R"]
    # the cache (L 2, B 8, T, Hkv 2, hd): batch over data; over model the
    # reference's rule takes the first other axis equal to Hkv, here L
    assert r["cache_placements"] == {"k": ["S1", "S0"], "v": ["S1", "S0"]}


def test_sharded_step_2x2x2_pod_data_model_matches_single(sharded8):
    """The multi-pod mesh's layout: the batch over pod and data, the
    vocab-sharded embedding table looked up where it lies
    (``rules._embedding``), no flatten left strided."""
    step = sharded8["internlm2-1.8b/pod_data_model"]
    _check_step(step)
    assert step["placements"]["embed.tok"] == ["R", "R", "S0"]


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if a != "internlm2-1.8b"])
def test_sharded_step_1x2_matches_single(sharded2, arch):
    _check_step(sharded2[f"{arch}/xla"])


@pytest.mark.parametrize("arch,impl", worker.SHARDED4)
def test_sharded_step_1x4_model_axis_outnumbers_heads(sharded4, arch, impl):
    """A (1, 4) mesh over the smoke models' 2 KV heads (whisper's and the
    xLSTM's 2 heads): K and V gathered whole before their head view,
    each rank's q heads meeting the KV head they share; held against
    the unsharded step and the reference's as the (1, 2) cases are."""
    assert sharded4["mesh"] == {"data": 1, "model": 4}
    _check_step(sharded4[f"{arch}/{impl}"])


#: (arch, impl) of sharded4 -> (q's placement over ``model``, the splits
#: ``rules.attention_plan`` may choose there) that the step's attention
#: meets
SHARDED4_SPLITS = {
    # 4 q heads over 2 KV heads: each rank's q head shares a KV head
    ("internlm2-1.8b", "xla"): ("S1", {"pick"}),
    ("internlm2-1.8b", "pallas"): ("S1", {"pick"}),
    # 2 heads: the batch rows of a replicated q
    ("whisper-tiny", "xla"): ("R", {"rows"}),
    # the second layer's q, k and v partial sums (torch 2.11: one KV
    # head picked) or partial means (2.13: the rows)
    ("dbrx-132b", "xla"): ("P", {"pick", "rows"}),
}


def test_sharded_step_1x4_attends_each_ranks_share(sharded4):
    """Every attention call of the (1, 4) steps splits the model axis,
    by heads or by batch rows: none leaves a rank all heads of all its
    rows (``rules.attention_plan``, recorded in the step).  A replicated
    q splits by rows, a head-split q by one picked KV head, a partial q
    by a picked KV head or, a partial mean, by rows; the steps are held
    against the unsharded one and the reference's by the (1, 4) test
    above."""
    for (arch, impl), (q, splits) in SHARDED4_SPLITS.items():
        calls = sharded4[f"{arch}/{impl}"]["attention"]
        assert calls and all(c["splits"][1] is not None for c in calls)
        assert any(c["q"][1] == q and c["splits"][1] in splits
                   for c in calls), (arch, calls)


@pytest.mark.parametrize("arch,impl,B", worker.SMALL4)
def test_sharded_step_1x4_batch_under_model_axis(small4, arch, impl, B):
    """The (1, 4) steps at batches whose rows are fewer than the model
    axis (2: each sharded4 case, and qwen2-7b's biases) or no multiple of
    it (3; 6, which DTensor splits 2, 2, 2, 0): the logits reach the
    loss as partial sums over ``model``, and the flattened rows of 6
    split unevenly.  Every gradient leaf finite and held against the
    unsharded step and the reference's ``jax.value_and_grad`` at the
    same batch."""
    assert small4["mesh"] == {"data": 1, "model": 4}
    r = small4[f"{arch}/{impl}/{B}"]
    assert all(np.isfinite(e) for e in r["grad_err"].values()), r["grad_err"]
    _check_step(r)


def test_loss_reads_partial_logits_split_on_the_vocab(small4, sharded4):
    """Logits that reach the loss as a partial sum over ``model`` (2 rows
    over 4 ranks, where the head contracts a partial input: torch 2.13's
    rule for the CPU's ``mm``; 2.11's keeps the head's split of V) are
    reduce-scattered onto the vocab, which the head's weight splits
    there (``rules.reduced_logits``), once: the loss never reads a
    partial sum, so its max's backward compares the logits it saw.  At
    8 rows they arrive split (by rows on 2.13, on V on 2.11) and pass as
    they are."""
    first = small4["internlm2-1.8b/xla/2"]["logits"]
    assert first and all(read == ["S0", "S2"] for _, read in first), first
    for arch, impl, B in worker.SMALL4:
        r = small4[f"{arch}/{impl}/{B}"]
        assert r["logits"] and all("P" not in read
                                   for _, read in r["logits"]), (arch, B)
    eight = sharded4["internlm2-1.8b/xla"]["logits"]
    assert eight and all(came == read and "P" not in read
                         for came, read in eight), eight


def test_sharded_step_2x4_two_rows_a_data_shard(sharded8):
    """A (2, 4) mesh at a batch of 4: 2 rows a data shard under a model
    axis of 4, the multi-pod train cells' layout (8 rows a rank against
    ``model`` 16) in small."""
    step = sharded8["internlm2-1.8b/2x4"]
    _check_step(step)
    assert all("P" not in read for _, read in step["logits"])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-tiny"])
def test_sharded_step_through_flash_path_matches_single(sharded2, arch):
    """``attn_impl="pallas"``: attention on each rank's local heads (the
    kernels' plain versions on the CPU)."""
    _check_step(sharded2[f"{arch}/pallas"])


@pytest.mark.parametrize("split", list(worker.DECODE2))
def test_decode_on_a_split_cache_matches_unsharded(decode2, split):
    """Prefill and four decode steps (two at one position, two at a
    position a sequence, on both ranks' slots) from the reference's
    params, with the cache split over ``model`` by layer (the reference's
    rule takes the layer axis where the layers number the KV heads), by
    KV head, by sequence (flash-decoding's combine) and by head dim (its
    longest axis at 16 slots; partial scores), and by layer over a single
    KV head, placed so by hand (``layer_serial``: three layers, two on
    one rank and one on the other; the heads do not divide, so each
    layer's holder attends it alone).  The logits and the
    written cache, as max |difference| over max |value|, within 1e-5
    (float32 summed in another order): sharded against unsharded, and
    both against the reference's same calls (``prefill``,
    ``decode_step``).  Split by layer, every rank attends each layer on
    its own KV head, or, over one KV head, each rank its own layer whole
    (:func:`_check_cache_case`)."""
    r = decode2
    assert r["mesh"] == {"data": 1, "model": 2}
    _check_cache_case(r[split], calls=5)


def _check_cache_case(case, calls):
    """decode2's bounds on one case of ``calls`` serving calls; on a
    cache split by layer, besides, every rank attends every layer of
    every call on its own half of the q and KV heads, so that no rank
    runs a layer's attention over all of its heads -- or, where the KV
    heads do not divide over the two ranks, each rank attends the layers
    it holds (the first rank the larger half), on all of their heads,
    and no other."""
    assert case["placements"][1] == f"S{case['split_dim']}"
    for against in ("sharded", "ref_single", "ref_sharded"):
        err = case[against]
        assert len(err["logits"]) == calls
        assert max(err["logits"]) < 1e-5, (against, err)
        assert err["cache"] < 1e-5, (against, err)
    if case["split_dim"] == 0:
        n_layers, (hq, hkv) = case["layers"], case["heads"]
        if hkv % 2 == 0:
            want = [[[hq // 2, hkv // 2]] * (n_layers * calls)] * 2
        else:
            want = [[[hq, hkv]] * (held * calls)
                    for held in (n_layers - n_layers // 2, n_layers // 2)]
        assert case["attention"] == want


@pytest.mark.parametrize("split", list(worker.PREFILL2))
def test_prefill_on_a_split_cache_matches_unsharded(decode2, split):
    """A prefill of 24 tokens into a 32-slot cache of two layers and two
    KV heads split by layer over ``model``: each rank attends its KV
    head of both layers, and the holder writes the new rows of both
    heads.  Held as decode2's cases: the logits and the written cache
    within 1e-5 of the unsharded call's and the reference's
    ``prefill``."""
    _check_cache_case(decode2[f"prefill_{split}"], calls=1)


@pytest.mark.parametrize("mode", worker.MOE4_COMBINE)
def test_expert_parallel_dispatch_step_matches_reference(moe4, mode):
    """olmoe's smoke step on a (2, 2) mesh with the dry run's dispatch
    (``dryrun.set_dispatch``: two token groups over ``data``, the experts
    over ``model``), under each ``COMBINE_MODE``: the loss and every
    gradient leaf against the reference's ``jax.value_and_grad`` with two
    groups and against the unsharded step (the existing bounds).  The
    dispatch buffer and the expert outputs -- the (G, E C, d) side of
    every row op of the forward -- are split as the reference constrains
    them: the groups over ``data`` (``Shard(0)``), the experts' slots
    over ``model`` (``Shard(1)``)."""
    r = moe4
    assert r["mesh"] == {"data": 2, "model": 2}
    case = r[mode]
    _check_step(case)
    slots = case["slots"]
    # two layers, a dispatch and a combine each, in each of the two
    # sharded forwards (the remat recompute may add some)
    assert len(case["rows"]) >= 8, case["rows"]
    for op, S, J, s_side, j_side in case["rows"]:
        assert slots in (S, J), (op, S, J)
        side = j_side if J == slots else s_side
        assert side == ["S0", "S1"], (op, S, J, s_side, j_side)


def test_vocab_parallel_lookup_equals_whole_table(decode2):
    """Megatron's lookup of a vocab-split table (each rank its rows,
    zeros for the rest, one all-reduce) and its gradient (each rank's
    rows, no communication) bit for bit the whole table's."""
    r = decode2["lookup"]
    assert r["rows_equal"] and r["grad_equal"]
    assert r["out_placements"] == ["R", "R"]
    assert r["grad_placements"] == ["R", "S0"]


def test_one_rank_mesh_step_is_bitwise_unsharded(single1):
    r = single1
    for impl in ("pallas", "xla"):
        got = r[impl]
        assert got["loss_equal"] and got["gnorm_equal"], impl
        assert got["unequal_leaves"] == [] and got["leaves"] > 10, impl


def test_sharded_checkpoint_restores_unsharded_and_back(single1):
    r = single1
    assert r["restore_plain_equal"] and r["restore_sharded_equal"]
    assert r["restore_sharded_placements"]


def test_flash_launch_checks_refuse_a_dtensor(single1):
    assert single1["kernel_refuses_dtensor"]


#: the reference's pipeline_forward and compressed_psum over 4 forced host
#: devices, on the worker's collect4 arrays
REF_FOUR = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed import compression, pipeline
    from repro.distributed.pipeline import shard_map
    assert len(jax.devices()) == 4, jax.devices()
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("pod",))
    S, mb, M, d = 4, 2, 4, 8
    rng = np.random.default_rng(1)
    w = rng.normal(size=(S, d, d)).astype(np.float32) * 0.3
    x = rng.normal(size=(M, mb, d)).astype(np.float32)
    pp = pipeline.pipeline_forward(lambda wi, h: jnp.tanh(h @ wi),
                                   jnp.asarray(w), jnp.asarray(x), mesh=mesh,
                                   stage_axis="pod")
    g = np.random.default_rng(3).normal(size=(4, 64)).astype(np.float32) * 0.01

    def red(gl, el):
        m, ne = compression.compressed_psum(gl[0], el[0], "pod")
        return m[None], ne[None]

    fn = shard_map(red, mesh=mesh, in_specs=(P("pod"), P("pod")),
                   out_specs=(P("pod"), P("pod")), check_vma=False)
    mean, err = fn(jnp.asarray(g), jnp.zeros((4, 64), jnp.float32))
    print(json.dumps({"mean_hex": np.asarray(mean[0]).tobytes().hex(),
                      "err_hex": np.asarray(err[0]).tobytes().hex(),
                      "pp_out": np.asarray(pp).ravel().tolist()}))
""")


@pytest.fixture(scope="module")
def reference_four():
    res = subprocess.run([sys.executable, "-c", REF_FOUR],
                         env=subprocess_env(4), capture_output=True,
                         text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_pipeline_forward_matches_direct_apply(collect4, reference_four):
    r = collect4
    assert r["pp_err"] < 1e-5
    assert r["microbatch_roundtrip"]
    # and the reference's pipeline_forward on the same arrays
    got, want = np.array(r["pp_out"]), np.array(reference_four["pp_out"])
    assert got.shape == want.shape == (4 * 2 * 8,)
    assert np.abs(got - want).max() < 1e-5


def test_compressed_psum_matches_reference_bitwise(collect4, reference_four):
    r = collect4
    assert r["psum_err"] < 2e-4 and r["ranks_agree"] and r["tree_psum_equal"]
    want = reference_four
    assert r["mean_hex"] == want["mean_hex"]
    assert r["err_hex"] == want["err_hex"]


# -- the launcher under torch.distributed.run ------------------------------------------

def _launch(ckpt_dir, steps, *extra, ranks=2, batch=4):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(ranks), "-m", "repro_torch.launch.train",
           "--arch", "internlm2-1.8b", "--smoke", "--steps", str(steps),
           "--batch", str(batch), "--seq-len", "16", "--model-axis", str(ranks),
           "--device", "cpu", "--ckpt-dir", str(ckpt_dir), *extra]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def _leaves(ckpt_dir, step):
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    return {l["name"]: np.load(os.path.join(d, l["file"]))
            for l in man["leaves"]}


def test_launch_train_model_axis_resumes_and_restores_unsharded(tmp_path):
    """The launcher checkpoints every 25 steps, as the reference's does:
    a 25-step run over two ranks, then its resume to 27 (the resume's
    bits are held by test_sharded_loop_resume_is_bitwise)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import build_model
    from repro_torch.runtime.train import init_train_state
    from repro_torch.tree import named_leaves

    out = _launch(tmp_path, 25)
    assert "mesh: {'data': 1, 'model': 2}" in out
    assert "steps 0..24: loss" in out and out.count("steps 0..24") == 1
    saved = _leaves(tmp_path, 25)
    out = _launch(tmp_path, 27, "--resume")
    assert "resumed at step 25" in out and "steps 25..26: loss" in out
    # the sharded run's checkpoint restores into a one-process state
    model = build_model(configs.get_smoke("internlm2-1.8b"), device="cpu")
    like = init_train_state(model, torch.Generator().manual_seed(1))
    state = CheckpointManager(str(tmp_path)).restore(like, step=25)
    assert int(state["step"]) == 25
    assert sorted(n for n, _ in named_leaves(state)) == sorted(saved)
    for n, v in named_leaves(state):
        assert v.numpy().tobytes() == saved[n].tobytes(), n


@pytest.mark.parametrize("batch", [4, 2])
def test_launch_train_model_axis_4_over_two_kv_heads(tmp_path, batch):
    """``launch.train --model-axis 4`` on the smoke internlm2 (2 KV
    heads) over 4 ranks: 3 steps whose first and last losses (printed to
    4 places) are those of the same run in one process, unsharded; at a
    batch of 4, and of 2 (fewer rows than ranks: the logits reach the
    loss as partial sums)."""
    def span(out):
        line = next(x for x in out.splitlines() if x.startswith("steps 0..2"))
        return [float(v) for v in line.split("loss ")[1].split(" -> ")]

    out = _launch(tmp_path / "four", 3, ranks=4, batch=batch)
    assert "mesh: {'data': 1, 'model': 4}" in out
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "internlm2-1.8b", "--smoke", "--steps", "3", "--batch", str(batch),
         "--seq-len", "16", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "one")], env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert one.returncode == 0, one.stderr[-4000:]
    got, want = span(out), span(one.stdout)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1.5e-4)


def test_sharded_loop_resume_is_bitwise(sharded2):
    """TrainLoop over a (1, 2) mesh, checkpointing every step: 2 steps,
    a restore into a fresh sharded state and 1 more equal 3 straight
    steps bit for bit, in every leaf of the state."""
    r = sharded2["resume"]
    assert r["resumed_at"] == 2 and r["steps"] == 3
    assert r["unequal_leaves"] == [] and r["leaves"] > 10
