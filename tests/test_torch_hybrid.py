"""The port's jamba hybrid held against the reference's.

At jamba-1.5-large's smoke config (4 layers = one period: Mamba + MLP,
Mamba + MoE, Mamba + MLP, attention + MoE; d 64, 4 experts top 2,
d_state 4, float32) the reference initialises the params from a PRNG
key, :func:`params_from_jax` carries them over, and both packages run
the same seeded numpy tokens: the cache-less forward under ``xla`` and
``interpret`` (and the port's ``pallas``, whose wrapper runs the plain
version on the CPU, against the reference's ``interpret``), prefill,
decode and the cache.

Tolerance rtol = atol = 2e-4, the decoders' and the xLSTM's: both sides
sum in float32, in another order, through the scans and projections.
The smoke hybrid's logits reach about 70 (the tied embedding at scale 1:
a position's own token scores about |e|^2 = d); the bound is absolute
all the same.
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
from repro.models import hybrid as r_hybrid
from repro.runtime import losses as r_losses
from repro_torch import configs as t_configs
from repro_torch.models import build_model, hybrid, params_from_jax
from repro_torch.models import moe as t_moe
from repro_torch.runtime import losses as t_losses

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _reference_params():
    return r_build_model(r_configs.get_smoke(ARCH)).init(jax.random.PRNGKey(0))


def _np_params():
    return jax.tree_util.tree_map(np.asarray, _reference_params())


def _pair(r_impl="xla", t_impl=None):
    """(reference model, its params, port model, port params)."""
    r_model = r_build_model(r_configs.get_smoke(ARCH), attn_impl=r_impl)
    t_cfg = t_configs.get_smoke(ARCH)
    t_model = build_model(t_cfg, attn_impl=t_impl or r_impl, device="cpu")
    return (r_model, _reference_params(), t_model,
            params_from_jax(t_cfg, _np_params(), device="cpu"))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_model(seed=0):
    cfg = t_configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("r_impl,t_impl", [
    ("xla", "xla"), ("interpret", "interpret"),
    ("interpret", "pallas"),     # the wrapper's plain version on the CPU
])
def test_hybrid_forward_matches_reference(r_impl, t_impl, rng):
    r_model, r_params, t_model, t_params = _pair(r_impl, t_impl)
    cfg = t_model.cfg
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want = np.asarray(r_model.forward(r_params, {"tokens": jnp.asarray(tokens)}))
    got = t_model.forward(t_params, {"tokens": torch.from_numpy(tokens).long()})
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab)
    np.testing.assert_allclose(_np(got), want, **TOL)
    r_loss = float(r_losses.next_token_loss(jnp.asarray(want), jnp.asarray(tokens)))
    t_loss = float(t_losses.next_token_loss(got, torch.from_numpy(tokens).long()))
    assert abs(t_loss - r_loss) <= 2e-4 * abs(r_loss)


@pytest.mark.parametrize("get", ["get", "get_smoke"])
def test_hybrid_init_cache_is_laid_out_like_the_reference(get):
    """k and v (n_periods, B, max_len, Hkv, hd) and conv (n_periods,
    n_mamba, B, K-1, d_in) in the compute dtype, ssm (..., d_in, S) in
    float32, all zeros; the full config by ``jax.eval_shape``."""
    r_cfg, t_cfg = getattr(r_configs, get)(ARCH), getattr(t_configs, get)(ARCH)
    want = jax.eval_shape(lambda: r_hybrid.hybrid_init_cache(r_cfg, 3, 10))
    got = hybrid.hybrid_init_cache(t_cfg, 3, 10, device="meta")
    assert set(got) == set(want) == {"k", "v", "conv", "ssm"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == want[k].dtype.name
    assert got["ssm"].dtype == torch.float32
    small = hybrid.hybrid_init_cache(t_configs.get_smoke(ARCH), 2, 4)
    assert all(not v.any() for v in small.values())


def test_hybrid_prefill_and_decode_match_reference(rng):
    """Prefill of 4 tokens, then scalar decode steps: logits within TOL
    of the reference's and of the port's own teacher-forced forward (one
    MoE slot a token, so nothing drops, as prefill's and decode's default
    capacity already give), and every part of the cache -- k and v
    written in place, new conv and ssm stacks -- within TOL of the
    reference's updated copy."""
    r_model, r_params, t_model, t_params = _pair()
    cfg = t_model.cfg
    B, T, P = 2, 8, 4
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    tt = torch.from_numpy(tokens).long()
    full = _np(t_model.forward(t_params, {"tokens": tt}, moe_capacity=B * T))

    r_cache, t_cache = r_model.init_cache(B, T), t_model.init_cache(B, T)
    given = t_cache
    r_lg, r_cache = r_model.prefill(
        r_params, {"tokens": jnp.asarray(tokens[:, :P])}, r_cache)
    t_lg, t_cache = t_model.prefill(t_params, {"tokens": tt[:, :P]}, t_cache)
    assert t_lg.shape == (B, cfg.vocab)
    assert t_cache["k"] is given["k"] and t_cache["v"] is given["v"]
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    np.testing.assert_allclose(_np(t_lg), full[:, P - 1], **TOL)
    for t in range(P, T):
        r_lg, r_cache = r_model.decode_step(
            r_params, jnp.asarray(tokens[:, t]), r_cache, jnp.int32(t))
        idx = t if t % 2 else torch.tensor(t)   # an int or a 0-d tensor
        t_lg, t_cache = t_model.decode_step(t_params, tt[:, t], t_cache, idx)
        np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
        np.testing.assert_allclose(_np(t_lg), full[:, t], **TOL)
    assert set(t_cache) == set(r_cache)
    for k in r_cache:
        assert tuple(t_cache[k].shape) == r_cache[k].shape, k
        np.testing.assert_allclose(_np(t_cache[k]), np.asarray(r_cache[k]),
                                   **TOL, err_msg=k)


def test_hybrid_decode_matches_its_teacher_forced_forward(rng):
    """Port only, with params from its own generator: prefill of a prompt
    and greedy decode give the full forward's logits, position by
    position, and so does decode from an empty cache token by token."""
    model, params = _port_model()
    cfg = model.cfg
    B, P, n = 2, 5, 6
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P))).long()
    lg, cache = model.prefill(params, {"tokens": prompt},
                              model.init_cache(B, P + n))
    seq, steps = prompt, [lg]
    for t in range(P, P + n - 1):
        tok = steps[-1].argmax(-1)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        lg, cache = model.decode_step(params, tok, cache, t)
        steps.append(lg)
    full = model.forward(params, {"tokens": seq}, moe_capacity=B * seq.shape[1])
    for i, lg in enumerate(steps):
        torch.testing.assert_close(lg, full[:, P - 1 + i], **TOL)
    cache = model.init_cache(B, seq.shape[1])
    for t in range(seq.shape[1]):
        lg, cache = model.decode_step(params, seq[:, t], cache, t)
        torch.testing.assert_close(lg, full[:, t], **TOL)


def test_hybrid_decode_leaves_the_mamba_states_unchanged(rng):
    """Prefill and decode return new conv and ssm stacks and write nothing
    into those they were given; the k and v they were given are the ones
    they write."""
    model, params = _port_model(seed=1)
    B = 2
    tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab, (B, 6))).long()
    given = model.init_cache(B, 8)
    _, cache = model.prefill(params, {"tokens": tokens}, given)
    assert not given["conv"].any() and not given["ssm"].any()
    assert given["k"].any()                         # written in place
    snap = {k: cache[k].clone() for k in ("conv", "ssm")}
    _, after = model.decode_step(params, tokens[:, -1], cache, 6)
    for k, v in snap.items():
        assert torch.equal(cache[k], v), k
        assert after[k] is not cache[k] and not torch.equal(after[k], v), k
    assert after["k"] is cache["k"] is given["k"]


def test_hybrid_decode_takes_a_scalar_cache_index(rng):
    model, params = _port_model()
    cache = model.init_cache(2, 4)
    tok = torch.zeros(2, dtype=torch.long)
    with pytest.raises((RuntimeError, ValueError)):
        model.decode_step(params, tok, cache, torch.tensor([1, 2]))


def test_moe_capacity_reaches_every_moe_sublayer(rng, monkeypatch):
    """``moe_capacity`` on forward, prefill and decode reaches the MoE of
    both odd sub-layers; where it forces drops (8 slots for 2 x 32
    tokens) the logits still match the reference given the same capacity
    and differ from the default capacity's."""
    r_model, r_params, t_model, t_params = _pair()
    cfg = t_model.cfg
    B, T, cap = 2, 32, 8
    n_moe = sum(i % 2 for i in range(cfg.attn_period))
    seen, apply = [], t_moe.moe_apply

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
    assert seen == [cap] * n_moe
    free = _np(t_model.forward(t_params, {"tokens": tt}, moe_capacity=B * T))
    assert np.abs(free - got).max() > 1e-3          # the drops changed logits

    r_cache, t_cache = r_model.init_cache(B, T + 1), t_model.init_cache(B, T + 1)
    r_lg, r_cache = r_model.prefill(r_params, {"tokens": jnp.asarray(tokens)},
                                    r_cache, moe_capacity=cap)
    seen.clear()
    t_lg, t_cache = t_model.prefill(t_params, {"tokens": tt}, t_cache,
                                    moe_capacity=cap)
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    r_lg, _ = r_model.decode_step(r_params, jnp.asarray(tokens[:, -1]), r_cache,
                                  jnp.int32(T), moe_capacity=cap)
    t_lg, _ = t_model.decode_step(t_params, tt[:, -1], t_cache, T,
                                  moe_capacity=cap)
    np.testing.assert_allclose(_np(t_lg), np.asarray(r_lg), **TOL)
    assert seen == [cap] * (2 * n_moe)


def test_params_from_jax_carries_the_periods_tree():
    """Every leaf of the reference's ``periods/sub{i}`` tree arrives with
    its values and its leading period axis; a missing Mamba leaf, a leaf
    of the wrong shape and a sub-layer of the wrong kind are each named."""
    cfg = t_configs.get_smoke(ARCH)
    good = _np_params()
    got = params_from_jax(cfg, good, device="cpu")
    assert "head" not in got
    for path, leaf in jax.tree_util.tree_leaves_with_path(good):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert got["periods"]["sub1"]["moe"]["w_gate"].shape == (
        1, cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert)

    def with_sub(i, sub):
        return dict(good, periods=dict(good["periods"], **{f"sub{i}": sub}))

    sub0 = good["periods"]["sub0"]
    no_alog = dict(sub0, mamba={k: v for k, v in sub0["mamba"].items()
                                if k != "A_log"})
    with pytest.raises(ValueError, match="periods/sub0/mamba: keys"):
        params_from_jax(cfg, with_sub(0, no_alog), device="cpu")
    unstacked = dict(sub0, ln1={"scale": sub0["ln1"]["scale"][0]})
    with pytest.raises(ValueError, match="periods/sub0/ln1/scale: \\(64,\\)"):
        params_from_jax(cfg, with_sub(0, unstacked), device="cpu")
    with pytest.raises(ValueError, match="periods/sub3: keys"):
        params_from_jax(cfg, with_sub(3, good["periods"]["sub1"]),
                        device="cpu")


@pytest.mark.parametrize("get", ["get", "get_smoke"])
def test_hybrid_init_on_meta_is_shaped_like_the_reference(get):
    """``hybrid_init`` on the meta device against the reference's tree
    (made by ``jax.eval_shape``, so the full config costs nothing): the
    same paths, shapes and dtypes."""
    r_cfg, t_cfg = getattr(r_configs, get)(ARCH), getattr(t_configs, get)(ARCH)
    want = jax.eval_shape(lambda k: r_build_model(r_cfg).init(k),
                          jax.random.PRNGKey(0))
    got = hybrid.hybrid_init(t_cfg, None, device="meta")
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert node.device.type == "meta"
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name, path


def test_cut_jamba_holds_25_37_b_params_in_under_52_gb():
    """jamba-1.5-large cut to one period (8 layers) and 8 experts, on
    meta: 25,373,859,840 parameters (four MoE layers 19.33 B, four dense
    MLPs 2.42 B, seven Mamba mixers of 420.3 M, one attention layer
    0.15 B, the embedding 0.54 B, whose sum rounded part by part is
    25.38 B; no head), 50.75 GB in bfloat16 apart from the float32 A_log
    and D."""
    full = t_configs.get(ARCH)
    cfg = dataclasses.replace(full, n_layers=8,
                              moe=dataclasses.replace(full.moe, n_experts=8))
    params = hybrid.hybrid_init(cfg, None, device="meta")
    leaves = jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor))
    n = sum(x.numel() for x in leaves)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    assert n == 25_373_859_840, n
    assert nbytes < 52e9, nbytes
    mamba = sum(x.numel() for x in jax.tree_util.tree_leaves(
        params["periods"]["sub0"]["mamba"],
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert abs(mamba - 420.3e6) < 0.05e6, mamba
    r_full = r_configs.get(ARCH)
    r_cut = dataclasses.replace(r_full, n_layers=8, moe=dataclasses.replace(
        r_full.moe, n_experts=8))
    want = jax.eval_shape(lambda k: r_hybrid.hybrid_init(r_cut, k),
                          jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))


def test_init_is_seeded_and_scaled_by_the_depth():
    """The same generator seed gives the same params; Mamba's out_proj
    and MoE's w_down scale with 1/sqrt(n_layers), as in the reference."""
    model, a = _port_model(seed=3)
    _, b = _port_model(seed=3)
    for path in (("sub0", "mamba", "in_proj", "w"), ("sub3", "attn", "wq", "w")):
        x, y = a["periods"], b["periods"]
        for key in path:
            x, y = x[key], y[key]
        assert torch.equal(x, y)
    cfg = model.cfg
    deep = dataclasses.replace(cfg, n_layers=4 * cfg.n_layers)
    p = hybrid.hybrid_init(deep, torch.Generator().manual_seed(3), device="cpu")
    d_in = cfg.mamba.expand * cfg.d_model
    for params, L in ((a, cfg.n_layers), (p, deep.n_layers)):
        w = params["periods"]["sub0"]["mamba"]["out_proj"]["w"]
        assert abs(w.std().item() * (d_in * 2 * L) ** 0.5 - 1) < 0.05
        wd = params["periods"]["sub1"]["moe"]["w_down"]
        ff = cfg.moe.d_ff_expert
        assert abs(wd.std().item() * (ff * 2 * L) ** 0.5 - 1) < 0.05
