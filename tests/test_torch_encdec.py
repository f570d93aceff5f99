"""The port's encoder-decoder (whisper) held against the reference's.

At whisper-tiny's smoke config (2 encoder and 2 decoder layers, d 32, 2
heads of 16, layernorm, gelu, tied embeddings, 12 frames, float32) the
reference initialises the params from a PRNG key,
:func:`params_from_jax` carries them over, and both packages run the
same seeded numpy frames and tokens: the scoring forward under ``xla``,
``interpret`` and the port's ``pallas`` (whose wrapper runs the plain
version on the CPU, against the reference's kernel in interpret mode),
``encode`` alone, prefill and decode, and the cache.

Tolerance rtol = atol = 2e-4, the decoders': both sides sum in float32,
in another order, through four layers and the vocab projection.  The
smoke model's logits reach about 32 (the tied embedding at scale 1: a
position's own token scores about |e|^2 = d); the bound is absolute all
the same.

The one deliberate difference from the reference: the encoder's
self-attention passes one block the length of the frame axis.  At
whisper's 1,500 frames the reference's default 512-row blocks do not
divide the axis and its kernel refuses them; non-causal, the blocks
change nothing that is computed.  The tests at 600 frames show both.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.kernels.attention.attention import flash_attention_pallas
from repro.models import build_model as r_build_model
from repro.models import transformer as r_transformer
from repro.runtime import losses as r_losses
from repro_torch import configs as t_configs
from repro_torch.kernels.attention import ops as t_ops
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import transformer as t_transformer
from repro_torch.runtime import losses as t_losses

ARCH = "whisper-tiny"
TOL = dict(rtol=2e-4, atol=2e-4)
#: chip_smoke.py's phase 5 bounds for two bfloat16 paths to the same
#: logits: max|diff| <= 5 % of max|logits|, argmax agreement >= 90 %
LOGIT_ATOL_FRAC, LOGIT_MIN_ARGMAX = 0.05, 0.9
#: a frame count the reference's default 512-row blocks do not divide
LONG_FRAMES = 600


@functools.lru_cache(maxsize=None)
def _reference_params(dtype="float32"):
    cfg = _cfgs(dtype)[0]
    return r_build_model(cfg).init(jax.random.PRNGKey(0))


def _cfgs(dtype="float32"):
    """(reference config, port config) at smoke widths in ``dtype``."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(r_configs.get_smoke(ARCH), **kw),
            dataclasses.replace(t_configs.get_smoke(ARCH), **kw))


def _np_params(dtype="float32"):
    return jax.tree_util.tree_map(np.asarray, _reference_params(dtype))


def _pair(r_impl="xla", t_impl=None, dtype="float32"):
    """(reference model, its params, port model, port params)."""
    r_cfg, t_cfg = _cfgs(dtype)
    r_model = r_build_model(r_cfg, attn_impl=r_impl)
    t_model = build_model(t_cfg, attn_impl=t_impl or r_impl, device="cpu")
    return (r_model, _reference_params(dtype), t_model,
            params_from_jax(t_cfg, _np_params(dtype), device="cpu"))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x, np.float32))


def _inputs(rng, cfg, B=2, T=8, frames=None):
    """Seeded numpy frames (B, frames, d_model) and tokens (B, T)."""
    Tf = frames or cfg.n_audio_frames
    return (rng.normal(size=(B, Tf, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab, (B, T)).astype(np.int32))


def _batches(frames, tokens):
    """The same batch for the reference and for the port."""
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)},
            {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens).long()})


def _port_model():
    cfg = t_configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("r_impl,t_impl", [
    ("xla", "xla"), ("interpret", "interpret"),
    ("interpret", "pallas"),     # the wrapper's plain version on the CPU
])
def test_encdec_forward_matches_reference(r_impl, t_impl, rng):
    r_model, r_params, t_model, t_params = _pair(r_impl, t_impl)
    cfg = t_model.cfg
    frames, tokens = _inputs(rng, cfg)
    r_batch, t_batch = _batches(frames, tokens)
    want = np.asarray(r_model.forward(r_params, r_batch))
    got = t_model.forward(t_params, t_batch)
    assert got.dtype == torch.float32 and got.shape == (2, 8, cfg.vocab)
    np.testing.assert_allclose(_np(got), want, **TOL)
    r_loss = float(r_losses.next_token_loss(jnp.asarray(want),
                                            jnp.asarray(tokens)))
    t_loss = float(t_losses.next_token_loss(got, t_batch["tokens"]))
    assert abs(t_loss - r_loss) <= 2e-4 * abs(r_loss)


@pytest.mark.parametrize("impl", ["xla", "interpret", "pallas"])
def test_encode_matches_reference(impl, rng):
    """The encoder alone: frames plus sinusoidal positions, non-causal
    self-attention, ``ln_enc``; the port's ``pallas`` against the
    reference's ``interpret``."""
    r_cfg, t_cfg = _cfgs()
    t_params = params_from_jax(t_cfg, _np_params(), device="cpu")
    frames, _ = _inputs(rng, t_cfg, B=3)
    want = r_transformer.encode(
        _reference_params(), jnp.asarray(frames), r_cfg,
        attn_impl="interpret" if impl == "pallas" else impl)
    got = t_transformer.encode(t_params, torch.from_numpy(frames), t_cfg,
                               attn_impl=impl)
    assert got.dtype == torch.float32 and got.shape == frames.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_encdec_prefill_and_decode_match_reference(rng):
    """Prefill of 4 tokens, then three scalar decode steps: logits within
    TOL of the reference's and of the port's own teacher-forced forward,
    the encoder output and every layer's self-attention k and v (written
    in place) within TOL of the reference's updated copy."""
    r_model, r_params, t_model, t_params = _pair()
    cfg = t_model.cfg
    B, T, P = 2, 7, 4
    frames, tokens = _inputs(rng, cfg, B=B, T=T)
    r_batch, t_batch = _batches(frames, tokens)
    full = _np(t_model.forward(t_params, t_batch))

    r_cache, t_cache = r_model.init_cache(B, T + 2), t_model.init_cache(B, T + 2)
    given = [dict(c) for c in t_cache["self"]]
    r_lg, r_cache = r_model.prefill(
        r_params, dict(r_batch, tokens=r_batch["tokens"][:, :P]), r_cache)
    t_lg, t_cache = t_model.prefill(
        t_params, dict(t_batch, tokens=t_batch["tokens"][:, :P]), t_cache)
    assert t_lg.shape == (B, cfg.vocab)
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    np.testing.assert_allclose(_np(t_lg), full[:, P - 1], **TOL)
    for t in range(P, T):
        r_lg, r_cache = r_model.decode_step(
            r_params, jnp.asarray(tokens[:, t]), r_cache, jnp.int32(t))
        idx = t if t % 2 else torch.tensor(t)   # an int or a 0-d tensor
        t_lg, t_cache = t_model.decode_step(
            t_params, t_batch["tokens"][:, t], t_cache, idx)
        np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
        np.testing.assert_allclose(_np(t_lg), full[:, t], **TOL)
    assert set(t_cache) == set(r_cache) == {"self", "enc"}
    np.testing.assert_allclose(_np(t_cache["enc"]), np.asarray(r_cache["enc"]),
                               **TOL)
    assert len(t_cache["self"]) == len(r_cache["self"]) == cfg.n_layers
    for i, (g, w, mine) in enumerate(zip(t_cache["self"], r_cache["self"],
                                         given)):
        for k in ("k", "v"):
            assert g[k] is mine[k], (i, k)          # written in place
            np.testing.assert_allclose(_np(g[k]), np.asarray(w[k]), **TOL,
                                       err_msg=f"layer {i} {k}")


def test_encdec_decode_clamps_the_position_like_the_reference(rng):
    """A cache_index at the end of the cache: the reference's
    ``dynamic_slice_in_dim`` of the positions and ``dynamic_update_slice``
    of k and v clamp their starts into the table, and so does the port."""
    r_model, r_params, t_model, t_params = _pair()
    cfg = t_model.cfg
    B, P, L = 2, 3, 4
    frames, tokens = _inputs(rng, cfg, B=B, T=P + 1)
    r_batch, t_batch = _batches(frames, tokens)
    r_cache, t_cache = r_model.init_cache(B, L), t_model.init_cache(B, L)
    _, r_cache = r_model.prefill(
        r_params, dict(r_batch, tokens=r_batch["tokens"][:, :P]), r_cache)
    _, t_cache = t_model.prefill(
        t_params, dict(t_batch, tokens=t_batch["tokens"][:, :P]), t_cache)
    r_lg, r_cache = r_model.decode_step(r_params, jnp.asarray(tokens[:, P]),
                                        r_cache, jnp.int32(L))
    t_lg, t_cache = t_model.decode_step(t_params, t_batch["tokens"][:, P],
                                        t_cache, L)
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    for g, w in zip(t_cache["self"], r_cache["self"]):
        np.testing.assert_allclose(_np(g["k"]), np.asarray(w["k"]), **TOL)


@pytest.mark.parametrize("get", ["get", "get_smoke"])
def test_encdec_init_cache_is_laid_out_like_the_reference(get):
    """A list of per-layer {k, v} (B, max_len, Hkv, hd) and the encoder
    buffer (B, n_audio_frames, d_model), in the compute dtype, zeros; the
    full config by ``jax.eval_shape``."""
    r_cfg, t_cfg = getattr(r_configs, get)(ARCH), getattr(t_configs, get)(ARCH)
    want = jax.eval_shape(lambda: r_transformer.encdec_init_cache(r_cfg, 3, 10))
    got = t_transformer.encdec_init_cache(t_cfg, 3, 10, device="meta")
    assert set(got) == set(want) == {"self", "enc"}
    assert len(got["self"]) == len(want["self"]) == t_cfg.n_layers
    pairs = [(got["enc"], want["enc"])] + [
        (g[k], w[k]) for g, w in zip(got["self"], want["self"]) for k in w]
    for g, w in pairs:
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
    small = t_transformer.encdec_init_cache(t_configs.get_smoke(ARCH), 2, 4,
                                            device="cpu")
    assert not small["enc"].any()
    assert all(not v.any() for c in small["self"] for v in c.values())


def test_encdec_cache_gives_every_layer_tensors_of_its_own(rng):
    """Prefill and decode write k and v in place, so a cache whose layers
    shared one k and one v (the reference's ``[dict(per_layer)] * n``,
    harmless with immutable arrays) would hold only the last layer's.
    Every layer's tensors are distinct storage, and after prefill each
    layer holds its own k and v."""
    model, params = _port_model()
    cfg = model.cfg
    B, P = 2, 4
    cache = model.init_cache(B, 6)
    ptrs = [t.data_ptr() for c in cache["self"] for t in c.values()]
    assert len(set(ptrs)) == len(ptrs) == 2 * cfg.n_layers
    frames, tokens = _inputs(rng, cfg, B=B, T=P)
    _, cache = model.prefill(params, {"frames": torch.from_numpy(frames),
                                      "tokens": torch.from_numpy(tokens).long()},
                             cache)
    for k in ("k", "v"):
        layers = [c[k][:, :P] for c in cache["self"]]
        assert all(x.abs().sum() > 0 for x in layers), k
        for i in range(1, len(layers)):
            assert not torch.allclose(layers[0], layers[i]), (k, i)


def test_encdec_decode_takes_a_scalar_cache_index():
    model, params = _port_model()
    cache = model.init_cache(2, 4)
    with pytest.raises(ValueError, match="scalar cache_index"):
        model.decode_step(params, torch.zeros(2, dtype=torch.long), cache,
                          torch.tensor([1, 2]))


# -- the block decision at a frame count 512 does not divide -----------------

def test_reference_encoder_kernel_refuses_frames_the_blocks_do_not_divide(rng):
    """At 600 frames the reference's encoder on its kernel (interpret
    mode) raises, as it would on its own chip at whisper's 1,500 frames."""
    r_cfg, _ = _cfgs()
    frames, _ = _inputs(rng, r_cfg, B=1, frames=LONG_FRAMES)
    with pytest.raises(ValueError, match="not divisible"):
        r_transformer.encode(_reference_params(), jnp.asarray(frames), r_cfg,
                             attn_impl="interpret")


@pytest.mark.parametrize("impl", ["interpret", "pallas"])
def test_port_encoder_at_frames_512_does_not_divide_equals_reference_xla(
        impl, rng, monkeypatch):
    """The port's encoder on its kernel path at 600 frames passes one
    whole-axis block (600, 600) to the attention and gives the
    reference's ``xla`` answer."""
    r_cfg, t_cfg = _cfgs()
    t_params = params_from_jax(t_cfg, _np_params(), device="cpu")
    frames, _ = _inputs(rng, t_cfg, B=1, frames=LONG_FRAMES)
    want = r_transformer.encode(_reference_params(), jnp.asarray(frames),
                                r_cfg, attn_impl="xla")
    seen, mha = [], t_ops.multi_head_attention

    def spy(q, k, v, **kw):
        seen.append((kw["impl"], kw["block_q"], kw["block_k"]))
        return mha(q, k, v, **kw)

    monkeypatch.setattr(t_ops, "multi_head_attention", spy)
    got = t_transformer.encode(t_params, torch.from_numpy(frames), t_cfg,
                               attn_impl=impl)
    assert seen == [(impl, LONG_FRAMES, LONG_FRAMES)] * t_cfg.n_encoder_layers
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["interpret", "pallas"])
def test_whole_axis_block_equals_reference_kernel(impl, rng):
    """On the same q, k, v (whisper's smoke heads, 600 frames,
    non-causal) the port's attention at the whole-axis block equals the
    reference's kernel in interpret mode at block_q = block_k = 600."""
    cfg = t_configs.get_smoke(ARCH)
    B, H, T, d = 2, cfg.n_heads, LONG_FRAMES, cfg.hd
    q, k, v = (rng.normal(size=(B * H, T, d)).astype(np.float32)
               for _ in range(3))
    kw = dict(n_q_heads=H, n_kv_heads=H, causal=False, block_q=T, block_k=T)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), interpret=True, **kw)
    got = t_ops.multi_head_attention(
        *(torch.from_numpy(x).reshape(B, H, T, d) for x in (q, k, v)),
        causal=False, impl=impl, block_q=T, block_k=T)
    np.testing.assert_allclose(_np(got).reshape(B * H, T, d), np.asarray(want),
                               **TOL)


# -- bfloat16, params and meta ----------------------------------------------

@pytest.mark.parametrize("t_impl", ["xla", "pallas"])
def test_bf16_encdec_forward_matches_reference(t_impl, rng):
    """bfloat16 params and activations at smoke widths, as whisper-tiny
    runs on the card, against the reference's bfloat16 ``xla`` forward,
    by phase 5's bounds: two bfloat16 paths round at other places (the
    port's ``pallas`` keeps p in float32 on the fma route at head dim 16,
    the reference's ``xla`` rounds it to bfloat16)."""
    r_model, r_params, t_model, t_params = _pair("xla", t_impl, "bfloat16")
    frames, tokens = _inputs(rng, t_model.cfg)
    r_batch, t_batch = _batches(frames, tokens)
    want = np.asarray(r_model.forward(r_params, r_batch), np.float32)
    got = t_model.forward(t_params, t_batch)
    assert got.dtype == torch.float32
    assert t_params["embed"]["tok"].dtype == torch.bfloat16
    got = _np(got)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_ATOL_FRAC * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= LOGIT_MIN_ARGMAX


def test_params_from_jax_carries_the_encdec_lists():
    """The reference's ``enc_blocks`` and ``dec_blocks`` lists arrive as
    lists with every leaf's values; a list of the wrong length and a
    decoder block without its cross-attention are each named."""
    cfg = t_configs.get_smoke(ARCH)
    good = _np_params()
    got = params_from_jax(cfg, good, device="cpu")
    assert "head" not in got                        # tied embeddings
    assert isinstance(got["enc_blocks"], list) and isinstance(
        got["dec_blocks"], list)
    for path, leaf in jax.tree_util.tree_leaves_with_path(good):
        node = got
        for key in path:
            node = node[key.idx if hasattr(key, "idx") else key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    with pytest.raises(ValueError, match="dec_blocks: 1 items, want a list of 2"):
        params_from_jax(cfg, dict(good, dec_blocks=good["dec_blocks"][:1]),
                        device="cpu")
    blocks = [dict(b) for b in good["dec_blocks"]]
    del blocks[1]["cross_attn"]
    with pytest.raises(ValueError, match="dec_blocks/1: keys"):
        params_from_jax(cfg, dict(good, dec_blocks=blocks), device="cpu")


@pytest.mark.parametrize("get", ["get", "get_smoke"])
def test_encdec_init_on_meta_is_shaped_like_the_reference(get):
    """``encdec_init`` on the meta device against the reference's tree
    (``jax.eval_shape``, so the full config costs nothing): the same
    paths, shapes and dtypes; at full size the 36,448,128 params of the
    tied embedding, four encoder and four decoder layers and their
    norms."""
    r_cfg, t_cfg = getattr(r_configs, get)(ARCH), getattr(t_configs, get)(ARCH)
    want = jax.eval_shape(lambda k: r_build_model(r_cfg).init(k),
                          jax.random.PRNGKey(0))
    got = t_transformer.encdec_init(t_cfg, None, device="meta")
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
        assert n == 36_448_128
