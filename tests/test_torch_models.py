"""The port's decoder models held against the reference's.

For the five dense and vlm smoke configs (internlm2, qwen2 with QKV bias,
qwen3 with qk-norm and an explicit head dim, command-r-plus with
layernorm and tied embeddings, chameleon) and the two MoE ones (olmoe,
64 experts cut to 8, top 2; dbrx with layernorm and GQA, 4 experts, top
2), the reference initialises the params from a PRNG key,
:func:`params_from_jax` carries them over, and both packages run the
same seeded numpy tokens.  Everything is float32 (the reference's
bfloat16 einsums do not execute on this CPU).

Tolerance rtol = atol = 2e-4 on logits of order 1: both sides accumulate
in float32 through two layers and the vocab projection, in another
summation order.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import build_model as r_build_model
from repro_torch import configs as t_configs
from repro.models import ssm as r_ssm
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_transformer
from repro_torch.runtime import losses as t_losses
from repro.runtime import losses as r_losses

ARCHS = ["internlm2-1.8b", "qwen2-7b", "qwen3-14b", "command-r-plus-104b",
         "chameleon-34b", "olmoe-1b-7b", "dbrx-132b"]
MOE_ARCHS = ["olmoe-1b-7b", "dbrx-132b"]
TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    return r_build_model(r_configs.get_smoke(arch)).init(jax.random.PRNGKey(0))


def _pair(arch, impl="xla"):
    """(reference model, its params, port model, port params)."""
    r_model = r_build_model(r_configs.get_smoke(arch), attn_impl=impl)
    r_params = _reference_params(arch)
    t_cfg = t_configs.get_smoke(arch)
    t_model = build_model(t_cfg, attn_impl=impl, device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, r_params)
    return r_model, r_params, t_model, params_from_jax(t_cfg, np_params,
                                                        device="cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_configs_are_copies_of_the_reference():
    assert t_configs.ARCH_IDS == r_configs.ARCH_IDS
    for arch in r_configs.ARCH_IDS:
        for get in ("get", "get_smoke"):
            want = getattr(r_configs, get)(arch)
            got = getattr(t_configs, get)(arch)
            assert got.__dict__ == want.__dict__ or (
                repr(got) == repr(want)), arch
            assert got.param_count() == want.param_count()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_forward_matches_reference(arch, impl, rng):
    r_model, r_params, t_model, t_params = _pair(arch, impl)
    cfg = t_model.cfg
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want = np.asarray(r_model.forward(r_params, {"tokens": jnp.asarray(tokens)}))
    got = t_model.forward(t_params, {"tokens": torch.from_numpy(tokens).long()})
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab)
    np.testing.assert_allclose(_np(got), want, **TOL)
    r_loss = float(r_losses.next_token_loss(jnp.asarray(want), jnp.asarray(tokens)))
    t_loss = float(t_losses.next_token_loss(got, torch.from_numpy(tokens).long()))
    assert abs(t_loss - r_loss) <= 2e-4 * abs(r_loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, rng):
    """Prefill, scalar decode steps, then one per-slot step with every
    sequence at its own position; logits within TOL of the reference and
    of the port's own teacher-forced forward.  MoE capacity depends on a
    call's token count, so the forward gets one slot per token (a
    token's top-k experts are distinct: nothing drops), as prefill (its
    B * P tokens fit the default 8 slots) and decode already have."""
    r_model, r_params, t_model, t_params = _pair(arch)
    cfg = t_model.cfg
    B, T, P = 2, 6, 4
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    tt = torch.from_numpy(tokens).long()
    full = _np(t_model.forward(t_params, {"tokens": tt}, moe_capacity=B * T))

    r_cache = r_model.init_cache(B, T + 4)
    t_cache = t_model.init_cache(B, T + 4)
    r_lg, r_cache = r_model.prefill(r_params, {"tokens": jnp.asarray(tokens[:, :P])},
                                    r_cache)
    t_lg, t_cache = t_model.prefill(t_params, {"tokens": tt[:, :P]}, t_cache)
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    np.testing.assert_allclose(_np(t_lg), full[:, P - 1], **TOL)
    for t in range(P, T - 1):
        r_lg, r_cache = r_model.decode_step(
            r_params, jnp.asarray(tokens[:, t]), r_cache, jnp.int32(t))
        t_lg, t_cache = t_model.decode_step(t_params, tt[:, t], t_cache, t)
        np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
        np.testing.assert_allclose(_np(t_lg), full[:, t], **TOL)
    np.testing.assert_allclose(_np(t_cache["k"]), np.asarray(r_cache["k"]), **TOL)

    # per-slot: slot 0 continues at T-1, slot 1 rewrites position P
    idx = np.array([T - 1, P], np.int32)
    tok = tokens[np.arange(B), idx]
    r_lg, r_cache = r_model.decode_step(r_params, jnp.asarray(tok), r_cache,
                                        jnp.asarray(idx))
    t_lg, t_cache = t_model.decode_step(t_params, torch.from_numpy(tok).long(),
                                        t_cache, torch.from_numpy(idx).long())
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    np.testing.assert_allclose(_np(t_lg[0]), full[0, T - 1], **TOL)
    np.testing.assert_allclose(_np(t_cache["v"]), np.asarray(r_cache["v"]), **TOL)


def test_port_decode_matches_its_teacher_forced_forward(rng):
    """Port only, with params from its own generator: greedy decode
    logits equal the full forward's, position by position."""
    cfg = t_configs.get_smoke("qwen3-14b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, P, n = 2, 5, 6
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P))).long()
    cache = model.init_cache(B, P + n)
    lg, cache = model.prefill(params, {"tokens": prompt}, cache)
    seq, steps = prompt, [lg]
    for t in range(P, P + n - 1):
        tok = steps[-1].argmax(-1)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        lg, cache = model.decode_step(params, tok, cache, t)
        steps.append(lg)
    full = model.forward(params, {"tokens": seq})
    for i, lg in enumerate(steps):
        torch.testing.assert_close(lg, full[:, P - 1 + i], **TOL)


def test_init_is_seeded_and_shaped_like_the_reference():
    cfg = t_configs.get_smoke("command-r-plus-104b")
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(3))
    b = model.init(torch.Generator().manual_seed(3))
    assert "head" not in a                       # tied embeddings
    assert torch.equal(a["blocks"]["attn"]["wq"]["w"], b["blocks"]["attn"]["wq"]["w"])
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                    _reference_params("command-r-plus-104b"))
    flat = jax.tree_util.tree_leaves_with_path(shapes, is_leaf=lambda x: isinstance(x, tuple))
    for path, shape in flat:
        node = a
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == shape


def test_params_from_jax_rejects_mismatches():
    cfg = t_configs.get_smoke("internlm2-1.8b")
    good = jax.tree_util.tree_map(np.asarray, _reference_params("internlm2-1.8b"))
    params_from_jax(cfg, good, device="cpu")
    bad = dict(good)
    del bad["head"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(cfg, bad, device="cpu")
    bad = dict(good, ln_f={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="ln_f/scale"):
        params_from_jax(cfg, bad, device="cpu")


def test_params_from_jax_carries_the_moe_leaves():
    """Every MoE leaf of the reference (``blocks/moe/router/w`` and the
    three expert stacks, each with a leading layer axis) arrives with
    its values; a missing ``w_down`` is named."""
    for arch in MOE_ARCHS:
        cfg = t_configs.get_smoke(arch)
        good = jax.tree_util.tree_map(np.asarray, _reference_params(arch))
        got = params_from_jax(cfg, good, device="cpu")["blocks"]
        assert "mlp" not in got
        L, E, d = cfg.n_layers, cfg.moe.n_experts, cfg.d_model
        ff = cfg.moe.d_ff_expert
        for path, shape in ((("router", "w"), (L, d, E)),
                            (("w_gate",), (L, E, d, ff)),
                            (("w_up",), (L, E, d, ff)),
                            (("w_down",), (L, E, ff, d))):
            t, r = got["moe"], good["blocks"]["moe"]
            for key in path:
                t, r = t[key], r[key]
            assert tuple(t.shape) == shape, path
            np.testing.assert_array_equal(t.numpy(), r)
        bad = dict(good, blocks=dict(good["blocks"],
                                     moe=dict(good["blocks"]["moe"])))
        del bad["blocks"]["moe"]["w_down"]
        with pytest.raises(ValueError, match="blocks/moe: keys"):
            params_from_jax(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacity_reaches_every_block(arch, rng, monkeypatch):
    """``moe_capacity`` on forward, prefill and (scalar and per-slot)
    decode reaches every layer's MoE block; where it forces drops
    (forward and prefill at 8 slots for 2 x 32 tokens) the logits still
    match the reference given the same capacity, and differ from the
    default capacity's."""
    r_model, r_params, t_model, t_params = _pair(arch)
    cfg = t_model.cfg
    L, B, T, cap = cfg.n_layers, 2, 32, 8
    from repro_torch.models import moe as t_moe

    seen, apply = [], t_moe.moe_apply          # each block's capacity

    def spy(p, x, cfg, *, capacity=None):
        seen.append(capacity)
        return apply(p, x, cfg, capacity=capacity)

    monkeypatch.setattr(t_moe, "moe_apply", spy)
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    tt = torch.from_numpy(tokens).long()

    want = np.asarray(r_model.forward(r_params, {"tokens": jnp.asarray(tokens)},
                                      moe_capacity=cap))
    got = _np(t_model.forward(t_params, {"tokens": tt}, moe_capacity=cap))
    np.testing.assert_allclose(got, want, **TOL)
    assert seen == [cap] * L
    free = _np(t_model.forward(t_params, {"tokens": tt}, moe_capacity=B * T))
    assert np.abs(free - got).max() > 1e-3        # the drops changed logits

    r_cache, t_cache = r_model.init_cache(B, T + 2), t_model.init_cache(B, T + 2)
    r_lg, r_cache = r_model.prefill(r_params, {"tokens": jnp.asarray(tokens)},
                                    r_cache, moe_capacity=cap)
    seen.clear()
    t_lg, t_cache = t_model.prefill(t_params, {"tokens": tt}, t_cache,
                                    moe_capacity=cap)
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    assert seen == [cap] * L

    tok = tokens[:, -1]
    r_lg, r_cache = r_model.decode_step(r_params, jnp.asarray(tok), r_cache,
                                        jnp.int32(T), moe_capacity=cap)
    seen.clear()
    t_lg, t_cache = t_model.decode_step(t_params, torch.from_numpy(tok).long(),
                                        t_cache, T, moe_capacity=cap)
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    idx = np.array([T + 1, T], np.int32)
    r_lg, _ = r_model.decode_step(r_params, jnp.asarray(tok), r_cache,
                                  jnp.asarray(idx), moe_capacity=cap)
    t_lg, _ = t_model.decode_step(t_params, torch.from_numpy(tok).long(),
                                  t_cache, torch.from_numpy(idx).long(),
                                  moe_capacity=cap)
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    assert seen == [cap] * (2 * L)


#: the first config of each family the reference serves, in ARCH_IDS
FAMILY_ARCHS = {t_configs.get_smoke(a).family: a
                for a in reversed(t_configs.ARCH_IDS)}


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_build_model_builds_every_family(family):
    """Every family in ``configs`` builds on the CPU, inits from a
    generator and scores a batch (the encoder-decoder's with frames)."""
    cfg = t_configs.get_smoke(FAMILY_ARCHS[family])
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    if cfg.is_encdec:
        batch["frames"] = torch.zeros(1, cfg.n_audio_frames, cfg.d_model)
    logits = model.forward(params, batch)
    assert logits.shape == (1, 4, cfg.vocab)
    assert torch.isfinite(logits).all()


def test_build_model_rejects_an_unknown_family():
    cfg = dataclasses.replace(t_configs.get_smoke("internlm2-1.8b"),
                              family="no-such-family")
    with pytest.raises(ValueError, match="unknown family 'no-such-family'"):
        build_model(cfg, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is that card")
    for arch in ("internlm2-1.8b", "olmoe-1b-7b", "xlstm-125m",
                 "jamba-1.5-large-398b", "whisper-tiny"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(t_configs.get_smoke(arch))


def test_cache_layout_matches_reference():
    cfg = t_configs.get_smoke("qwen3-14b")
    cache = t_transformer.decoder_init_cache(cfg, 3, 10, device="cpu")
    r_cache = r_build_model(r_configs.get_smoke("qwen3-14b")).init_cache(3, 10)
    assert tuple(cache["k"].shape) == tuple(r_cache["k"].shape)
    assert cache["v"].dtype == torch.float32


def test_layers_off_the_dense_path_match_reference(rng):
    """The layer functions the five configs do not reach -- gelu MLP,
    cross-attention (``kv``), sinusoidal positions -- against the
    reference's, on the same params."""
    from repro.models import layers as r_layers
    from repro_torch.models import layers as t_layers

    cfg = r_configs.get_smoke("whisper-tiny")
    assert cfg.act == "gelu"
    B, T, Ts, d = 2, 5, 7, cfg.d_model
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    src = rng.normal(size=(B, Ts, d)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    mlp = jax.tree_util.tree_map(np.asarray, r_layers.mlp_init(key, cfg, jnp.float32))
    attn = jax.tree_util.tree_map(np.asarray,
                                  r_layers.attention_init(key, cfg, jnp.float32))
    t_mlp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), mlp)
    t_attn = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), attn)
    np.testing.assert_allclose(
        _np(t_layers.mlp_apply(t_mlp, torch.from_numpy(x), cfg)),
        np.asarray(r_layers.mlp_apply(mlp, jnp.asarray(x), cfg)), **TOL)
    pos = np.broadcast_to(np.arange(T)[None], (B, T))
    want, _ = r_layers.attention_apply(
        attn, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
        kv=(jnp.asarray(src), jnp.asarray(src)), causal=False)
    got, _ = t_layers.attention_apply(
        t_attn, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos.copy()),
        kv=(torch.from_numpy(src), torch.from_numpy(src)), causal=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        _np(t_layers.sinusoidal_positions(12, d)),
        np.asarray(r_layers.sinusoidal_positions(12, d)), **TOL)


# -- the xLSTM (ssm_xlstm) --------------------------------------------------

XLSTM = "xlstm-125m"


@pytest.fixture
def restore_mlstm_chunk():
    """Both packages' ``MLSTM_CHUNK`` as it was before the test."""
    saved = [(m, m.MLSTM_CHUNK) for m in (r_ssm, t_ssm)]
    yield
    for m, chunk in saved:
        m.MLSTM_CHUNK = chunk


def _states_np(states):
    return [{k: _np(v) for k, v in s.items()} for s in states]


def _close_states(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        for k in w:
            assert g[k].dtype == torch.float32, (i, k)
            np.testing.assert_allclose(_np(g[k]), np.asarray(w[k]), **TOL,
                                       err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("chunk", [None, 4])
def test_xlstm_forward_matches_reference(chunk, rng, restore_mlstm_chunk):
    """The smoke xLSTM (sLSTM, then three mLSTM layers) on the exact
    recurrent scan and, with ``MLSTM_CHUNK = 4``, on chunks of 4 steps."""
    r_model, r_params, t_model, t_params = _pair(XLSTM)
    r_ssm.MLSTM_CHUNK = t_ssm.MLSTM_CHUNK = chunk
    cfg = t_model.cfg
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want = np.asarray(r_model.forward(r_params, {"tokens": jnp.asarray(tokens)}))
    got = t_model.forward(t_params, {"tokens": torch.from_numpy(tokens).long()})
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab)
    np.testing.assert_allclose(_np(got), want, **TOL)
    r_loss = float(r_losses.next_token_loss(jnp.asarray(want), jnp.asarray(tokens)))
    t_loss = float(t_losses.next_token_loss(got, torch.from_numpy(tokens).long()))
    assert abs(t_loss - r_loss) <= 2e-4 * abs(r_loss)


@pytest.mark.parametrize("chunk", [None, 2])
def test_xlstm_prefill_and_decode_match_reference(chunk, rng,
                                                  restore_mlstm_chunk):
    """Prefill of 4 tokens (chunked at ``MLSTM_CHUNK = 2``), then decode
    steps on the recurrent state: last-position logits and every layer's
    new state within TOL of the reference's.  ``cache_index`` is ignored
    by both, so each side gets another value."""
    r_model, r_params, t_model, t_params = _pair(XLSTM)
    r_ssm.MLSTM_CHUNK = t_ssm.MLSTM_CHUNK = chunk
    cfg = t_model.cfg
    B, T, P = 2, 8, 4
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    tt = torch.from_numpy(tokens).long()
    r_states, t_states = r_model.init_cache(B, T), t_model.init_cache(B, T)
    _close_states(t_states, r_states)
    r_lg, r_states = r_model.prefill(
        r_params, {"tokens": jnp.asarray(tokens[:, :P])}, r_states)
    t_lg, t_states = t_model.prefill(t_params, {"tokens": tt[:, :P]}, t_states)
    assert t_lg.shape == (B, cfg.vocab)
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    _close_states(t_states, r_states)
    for t in range(P, T):
        r_lg, r_states = r_model.decode_step(
            r_params, jnp.asarray(tokens[:, t]), r_states, jnp.int32(t))
        t_lg, t_states = t_model.decode_step(t_params, tt[:, t], t_states,
                                             1000 + t)
        np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    _close_states(t_states, r_states)


def test_xlstm_decode_matches_its_teacher_forced_forward(rng):
    """Port only, with params from its own generator: greedy decode on
    the O(1) state from an empty state gives the full forward's logits,
    position by position (the reference's
    ``test_xlstm_stateful_equals_stateless``), and so does prefill of a
    prompt followed by greedy decode."""
    cfg = t_configs.get_smoke(XLSTM)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, P, n = 2, 5, 6
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P))).long()
    lg, states = model.prefill(params, {"tokens": prompt},
                               model.init_cache(B, P + n))
    seq, steps = prompt, [lg]
    for t in range(P, P + n - 1):
        tok = steps[-1].argmax(-1)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        lg, states = model.decode_step(params, tok, states, t)
        steps.append(lg)
    full = model.forward(params, {"tokens": seq})
    for i, lg in enumerate(steps):
        torch.testing.assert_close(lg, full[:, P - 1 + i], **TOL)
    states = model.init_cache(B, 1)
    for t in range(seq.shape[1]):
        lg, states = model.decode_step(params, seq[:, t], states, t)
        torch.testing.assert_close(lg, full[:, t], **TOL)


def test_xlstm_leaves_the_states_passed_in_unchanged(rng, restore_mlstm_chunk):
    """Prefill (recurrent and chunked) and decode return new states and
    write nothing into the ones they were given."""
    cfg = t_configs.get_smoke(XLSTM)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    B = 2
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 8))).long()
    for chunk in (None, 4):
        t_ssm.MLSTM_CHUNK = chunk
        given = model.init_cache(B, 8)
        before = _states_np(given)
        _, states = model.prefill(params, {"tokens": tokens}, given)
        snap = _states_np(states)
        _, after = model.decode_step(params, tokens[:, -1], states, 8)
        for now, then in ((given, before), (states, snap)):
            for s, b in zip(_states_np(now), then):
                for k in b:
                    np.testing.assert_array_equal(s[k], b[k])
        assert any(not np.array_equal(a[k], b[k])
                   for a, b in zip(_states_np(after), snap) for k in b)
        assert any(not np.array_equal(a[k], b[k])
                   for a, b in zip(snap, before) for k in b)


def test_params_from_jax_carries_the_xlstm_list_tree():
    """The reference's list of ``{"ln", "core"}`` blocks arrives as a list
    with every leaf's values; a block of the wrong kind, a leaf of the
    wrong shape and a list of the wrong length are each named."""
    cfg = t_configs.get_smoke(XLSTM)
    good = jax.tree_util.tree_map(np.asarray, _reference_params(XLSTM))
    got = params_from_jax(cfg, good, device="cpu")
    assert isinstance(got["blocks"], list)
    assert len(got["blocks"]) == cfg.n_layers
    assert "head" not in got                        # tied embeddings
    for i, (t, r) in enumerate(zip(got["blocks"], good["blocks"])):
        kind = t_ssm.xlstm_block_kind(i, cfg)
        assert ("wz" in t["core"]) == (kind == "slstm"), i
        for key in r["core"]:
            for leaf in r["core"][key]:
                np.testing.assert_array_equal(t["core"][key][leaf].numpy(),
                                              r["core"][key][leaf])
    np.testing.assert_array_equal(got["embed"]["tok"].numpy(),
                                  good["embed"]["tok"])

    swapped = dict(good, blocks=[good["blocks"][1], good["blocks"][0],
                                 *good["blocks"][2:]])
    with pytest.raises(ValueError, match="blocks/0/core: keys.*blocks/1/core: keys"):
        params_from_jax(cfg, swapped, device="cpu")
    blocks = [dict(b) for b in good["blocks"]]
    blocks[2] = dict(blocks[2], core=dict(blocks[2]["core"],
                                          wq={"w": np.zeros((3, 3), np.float32)}))
    with pytest.raises(ValueError, match="blocks/2/core/wq/w: \\(3, 3\\)"):
        params_from_jax(cfg, dict(good, blocks=blocks), device="cpu")
    with pytest.raises(ValueError, match="blocks: 3 items, want a list of 4"):
        params_from_jax(cfg, dict(good, blocks=good["blocks"][:3]),
                        device="cpu")


@pytest.mark.parametrize("get", ["get", "get_smoke"])
def test_xlstm_init_on_meta_is_shaped_like_the_reference(get):
    """``xlstm_init`` on the meta device against the reference's tree
    (made by ``jax.eval_shape``, so the full config costs nothing): the
    same paths, shapes and dtypes; at full size the 68,789,064 params
    of the tied embedding, nine mLSTM and three sLSTM layers."""
    r_cfg, t_cfg = getattr(r_configs, get)(XLSTM), getattr(t_configs, get)(XLSTM)
    want = jax.eval_shape(lambda k: r_build_model(r_cfg).init(k),
                          jax.random.PRNGKey(0))
    got = t_transformer.xlstm_init(t_cfg, None, device="meta")
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for key in path:
            node = node[key.idx if hasattr(key, "idx") else key.key]
        assert node.device.type == "meta"
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name, path
        n += node.numel()
    assert len(jax.tree_util.tree_leaves(want)) == len(
        jax.tree_util.tree_leaves(got))
    if get == "get":
        assert n == 68_789_064
