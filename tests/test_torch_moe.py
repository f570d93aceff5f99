"""The port's Mixture-of-Experts FFN held against the reference's.

``moe_apply`` at the float32 smoke configs of olmoe-1b-7b (64-wide, 8
experts, top 2) and dbrx-132b (4 experts, top 2): the reference
initialises the params from a PRNG key, both packages run the same
seeded numpy activations, with forced drops, grouped dispatch (1, 2 and
4 groups, and a token count 4 does not divide, which falls back to one
group), both combine modes, swiglu and gelu experts, and an all-zero
router whose tied probabilities select experts 0..K-1 in both.

Tolerance rtol = atol = 2e-4 on outputs of order 0.1-1, as for the
decoder models: both sides accumulate in float32, in another summation
order.  Routing decisions (experts, gates and drops) are compared
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import moe as r_moe
from repro_torch import configs as t_configs
from repro_torch.models import moe as t_moe

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["olmoe-1b-7b", "dbrx-132b"]


@pytest.fixture(autouse=True)
def restore_moe_state():
    """Both packages' module state (groups, mesh axes, combine mode) as
    it was before the test."""
    saved = [(m, m._NUM_GROUPS, m._EP_SPEC, m.COMBINE_MODE)
             for m in (r_moe, t_moe)]
    yield
    for m, groups, spec, mode in saved:
        m._NUM_GROUPS, m._EP_SPEC, m.COMBINE_MODE = groups, spec, mode


def _cfgs(arch, **changes):
    r_cfg, t_cfg = r_configs.get_smoke(arch), t_configs.get_smoke(arch)
    if changes:
        r_cfg = dataclasses.replace(r_cfg, **changes)
        t_cfg = dataclasses.replace(t_cfg, **changes)
    return r_cfg, t_cfg


def _params(r_cfg, seed=0):
    """The reference's params as numpy, and the same as torch tensors."""
    p = jax.tree_util.tree_map(
        np.asarray, r_moe.moe_init(jax.random.PRNGKey(seed), r_cfg, jnp.float32))
    return p, jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), p)


def _set_mode(groups, mode):
    for m in (r_moe, t_moe):
        m.set_ep_sharding(None, (), num_groups=groups)
        m.COMBINE_MODE = mode


def _apply_both(arch, x, *, capacity=None, groups=1, mode="gather",
                seed=0, zero_router=False, **changes):
    r_cfg, t_cfg = _cfgs(arch, **changes)
    r_p, t_p = _params(r_cfg, seed)
    if zero_router:
        r_p["router"]["w"] = np.zeros_like(r_p["router"]["w"])
        t_p["router"]["w"] = torch.zeros_like(t_p["router"]["w"])
    _set_mode(groups, mode)
    want = np.asarray(r_moe.moe_apply(r_p, jnp.asarray(x), r_cfg,
                                      capacity=capacity))
    got = t_moe.moe_apply(t_p, torch.from_numpy(x), t_cfg, capacity=capacity)
    return got.numpy(), want, t_p, t_cfg


def _x(rng, arch, B=4, T=16):
    d = t_configs.get_smoke(arch).d_model
    return rng.normal(size=(B, T, d)).astype(np.float32)


def _kept_share(t_p, t_cfg, x, capacity):
    """The share of (token, expert) assignments the port keeps."""
    G = t_moe._NUM_GROUPS if (x.shape[0] * x.shape[1]) % t_moe._NUM_GROUPS == 0 else 1
    xt = torch.from_numpy(x).reshape(G, -1, x.shape[-1])
    keep = t_moe._route(t_p, xt, t_cfg, capacity)[4]
    return keep.float().mean().item()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["gather", "scatter"])
def test_moe_apply_matches_reference_at_default_capacity(arch, mode, rng):
    x = _x(rng, arch)
    got, want, _, _ = _apply_both(arch, x, mode=mode)
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("mode", ["gather", "scatter"])
def test_moe_apply_with_forced_drops_matches_reference(arch, groups, mode, rng):
    """A capacity that keeps about half of the assignments: the outputs,
    and so which assignments were dropped, agree for every group count.
    At 4 x 64 tokens, K = 2: olmoe's 8 experts get 64 assignments each
    on average, dbrx's 4 get 128; the capacity is half that, and each
    group gets capacity // G slots, half its average too."""
    x = _x(rng, arch, T=64)
    m = t_configs.get_smoke(arch).moe
    capacity = 4 * 64 * m.top_k // m.n_experts // 2
    got, want, t_p, t_cfg = _apply_both(arch, x, capacity=capacity,
                                        groups=groups, mode=mode)
    np.testing.assert_allclose(got, want, **TOL)
    kept = _kept_share(t_p, t_cfg, x, capacity)
    assert 0.3 < kept < 0.8, kept


@pytest.mark.parametrize("mode", ["gather", "scatter"])
def test_moe_apply_groups_fall_back_to_one_when_they_do_not_divide(mode, rng):
    """N = 3 x 5 tokens and 4 groups: both packages take G = 1, the same
    result as one group."""
    arch = "olmoe-1b-7b"
    x = _x(rng, arch, B=3, T=5)
    got, want, _, _ = _apply_both(arch, x, capacity=8, groups=4, mode=mode)
    np.testing.assert_allclose(got, want, **TOL)
    one, _, _, _ = _apply_both(arch, x, capacity=8, groups=1, mode=mode)
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["gather", "scatter"])
def test_moe_apply_gelu_experts_match_reference(arch, mode, rng):
    x = _x(rng, arch)
    got, want, _, _ = _apply_both(arch, x, capacity=16, mode=mode, act="gelu")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_picks_the_lowest_experts(arch, rng):
    """An all-zero router: every probability is 1/E, so the reference's
    top_k picks experts 0..K-1 with gates 1/K; so does the port, and the
    outputs agree, with and without drops."""
    cfg = t_configs.get_smoke(arch)
    K = cfg.moe.top_k
    x = _x(rng, arch)
    for capacity in (None, 16):
        got, want, t_p, _ = _apply_both(arch, x, capacity=capacity,
                                        zero_router=True)
        np.testing.assert_allclose(got, want, **TOL)
    gate, eidx = t_moe._route(t_p, torch.from_numpy(x).reshape(1, -1, cfg.d_model),
                              cfg, None)[:2]
    assert torch.equal(eidx, torch.arange(K).expand_as(eidx))
    torch.testing.assert_close(gate, torch.full_like(gate, 1.0 / K))


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_reference_top_k(arch, rng):
    """The port's experts and renormalised gates are the reference's
    ``lax.top_k`` of the softmax, in the same order."""
    r_cfg, t_cfg = _cfgs(arch)
    r_p, t_p = _params(r_cfg, seed=3)
    x = _x(rng, arch)
    logits = x.reshape(-1, x.shape[-1]) @ r_p["router"]["w"]
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    r_gate, r_eidx = jax.lax.top_k(probs, t_cfg.moe.top_k)
    r_gate = r_gate / jnp.clip(jnp.sum(r_gate, -1, keepdims=True), 1e-9)
    gate, eidx = t_moe._route(t_p, torch.from_numpy(x).reshape(1, -1, x.shape[-1]),
                              t_cfg, None)[:2]
    np.testing.assert_array_equal(eidx[0].numpy(), np.asarray(r_eidx))
    np.testing.assert_allclose(gate[0].numpy(), np.asarray(r_gate), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_load_balance_loss_matches_reference(arch, rng):
    E = t_configs.get_smoke(arch).moe.n_experts
    logits = rng.normal(size=(64, E)).astype(np.float32)
    eidx = rng.integers(0, E, (64, 2)).astype(np.int32)
    want = float(r_moe.aux_load_balance_loss(jnp.asarray(logits),
                                             jnp.asarray(eidx), E))
    got = t_moe.aux_load_balance_loss(torch.from_numpy(logits),
                                      torch.from_numpy(eidx), E)
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= 2e-4 * abs(want)


def test_init_shapes_and_scales_match_reference():
    """Leaves, shapes and per-leaf scales of the reference (stacked over
    a leading layer axis, as the decoder stacks them)."""
    cfg = t_configs.get_smoke("olmoe-1b-7b")
    m = cfg.moe
    p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                       lead=(cfg.n_layers,))
    r_p = r_moe.moe_init(jax.random.PRNGKey(0), r_configs.get_smoke("olmoe-1b-7b"),
                         jnp.float32)
    assert set(p) == set(r_p) and set(p["router"]) == set(r_p["router"])
    L, d, ff, E = cfg.n_layers, cfg.d_model, m.d_ff_expert, m.n_experts
    for name, shape, scale in (
            ("w_gate", (E, d, ff), d ** -0.5), ("w_up", (E, d, ff), d ** -0.5),
            ("w_down", (E, ff, d), (2 * ff * cfg.n_layers) ** -0.5)):
        assert tuple(r_p[name].shape) == shape
        assert tuple(p[name].shape) == (L, *shape)
        assert abs(p[name].std().item() / scale - 1) < 0.05, name
    assert tuple(p["router"]["w"].shape) == (L, d, E)


def test_set_ep_sharding_records_axes_and_groups():
    t_moe.set_ep_sharding("model", ("data",), num_groups=4)
    assert t_moe._EP_SPEC == ("model", ("data",)) and t_moe._NUM_GROUPS == 4
    t_moe.set_ep_sharding(None, (), num_groups=0)
    assert t_moe._EP_SPEC is None and t_moe._NUM_GROUPS == 1
