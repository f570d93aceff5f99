"""The port's recurrent blocks held against the reference's: the xLSTM
and the Mamba (S6) mixer of the jamba hybrid.

``mlstm_apply``, ``mlstm_apply_chunked`` (and its ``_mlstm_chunk_body``)
and ``slstm_apply`` at the float32 smoke config of xlstm-125m (d 32, 2
heads of 16): the reference initialises the params from a PRNG key, both
packages run the same seeded numpy activations, with and without a
carried state, a chunk that divides T and one that does not (the
recurrent fallback).

Tolerance rtol = atol = 2e-4 on outputs of order 0.1-2, as for the
decoder models: both sides accumulate in float32, in another summation
order, through the scans.  The reference's own chunked and recurrent
mLSTM agree within 4.5e-6 at T = 128, W = 64, so the port's chunked path
is held against its own recurrent one at the same 2e-4.

The Mamba mixer (``_causal_conv``, ``mamba_apply``, ``mamba_init_state``)
runs at jamba-1.5-large's float32 smoke config (d 64, d_in 128, d_state
4, d_conv 4), with and without a carried state, T below K-1 included
(decode has T = 1), at the same 2e-4.

Each step loop's backward writes O(T) bytes, its gradients the
reference's within the same 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as r_configs
from repro.models import ssm as r_ssm
from repro_torch import configs as t_configs
from repro_torch.models import ssm as t_ssm

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "xlstm-125m"
B = 2


@pytest.fixture(autouse=True)
def restore_mlstm_chunk():
    """Both packages' ``MLSTM_CHUNK`` as it was before the test."""
    saved = [(m, m.MLSTM_CHUNK) for m in (r_ssm, t_ssm)]
    yield
    for m, chunk in saved:
        m.MLSTM_CHUNK = chunk


def _cfgs(**changes):
    r_cfg, t_cfg = r_configs.get_smoke(ARCH), t_configs.get_smoke(ARCH)
    if changes:
        r_cfg = dataclasses.replace(r_cfg, **changes)
        t_cfg = dataclasses.replace(t_cfg, **changes)
    return r_cfg, t_cfg


def _torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(kind, r_cfg, seed=0, dtype=jnp.float32):
    init = r_ssm.mlstm_init if kind == "mlstm" else r_ssm.slstm_init
    p = init(jax.random.PRNGKey(seed), r_cfg, dtype)
    return p, jax.tree_util.tree_map(_torch, p)


def _state(kind, rng, r_cfg, t_cfg):
    """A carried state of ``kind`` as after some steps: random C/c and n,
    stabilizers of either sign; the same values for both packages."""
    st = jax.tree_util.tree_map(np.asarray,
                                r_ssm.xlstm_init_state(r_cfg, B, kind))
    st = {k: (rng.normal(size=v.shape) * (0.5 if k == "m" else 1.0))
          .astype(np.float32) for k, v in st.items()}
    if kind == "slstm":
        st["n"] = np.abs(st["n"]) + 0.5                # a sum of gates
    want = t_ssm.xlstm_init_state(t_cfg, B, kind)
    assert {k: (v.shape, v.dtype) for k, v in want.items()} == {
        k: (tuple(v.shape), torch.float32) for k, v in st.items()}
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v) for k, v in st.items()})


def _x(rng, T, d):
    return rng.normal(size=(B, T, d)).astype(np.float32)


def _check(got, want, tol=TOL):
    (y_t, s_t), (y_r, s_r) = got, want
    np.testing.assert_allclose(_np(y_t), _np(y_r), **tol)
    if s_r is None:
        assert s_t is None
        return
    assert set(s_t) == set(s_r)
    for k in s_r:
        assert s_t[k].dtype == torch.float32, k
        np.testing.assert_allclose(_np(s_t[k]), _np(s_r[k]), **tol, err_msg=k)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_apply_matches_reference(with_state, rng):
    r_cfg, t_cfg = _cfgs()
    r_p, t_p = _params("mlstm", r_cfg)
    x = _x(rng, 12, r_cfg.d_model)
    r_st, t_st = (_state("mlstm", rng, r_cfg, t_cfg) if with_state
                  else (None, None))
    want = r_ssm.mlstm_apply(r_p, jnp.asarray(x), r_cfg, state=r_st)
    got = t_ssm.mlstm_apply(t_p, torch.from_numpy(x), t_cfg, state=t_st)
    _check(got, want)


@pytest.mark.parametrize("T,chunk,with_state", [
    (16, 4, False),    # W divides T
    (64, 16, False),   # wider chunks
    (14, 4, False),    # ragged: the recurrent fallback
    (16, 8, True),     # a carried state through every chunk
])
def test_mlstm_apply_chunked_matches_reference(T, chunk, with_state, rng):
    r_cfg, t_cfg = _cfgs()
    r_p, t_p = _params("mlstm", r_cfg, seed=1)
    x = _x(rng, T, r_cfg.d_model)
    r_st, t_st = (_state("mlstm", rng, r_cfg, t_cfg) if with_state
                  else (None, None))
    want = r_ssm.mlstm_apply_chunked(r_p, jnp.asarray(x), r_cfg, chunk=chunk,
                                     state=r_st)
    got = t_ssm.mlstm_apply_chunked(t_p, torch.from_numpy(x), t_cfg,
                                    chunk=chunk, state=t_st)
    _check(got, want)


def test_mlstm_chunk_body_matches_reference(rng):
    """One chunk on its own, from a carried state with a stabilizer of
    either sign, gates wide enough that the cumulative max moves."""
    Bh, H, W, hd = 2, 3, 8, 5
    q, k, v = (rng.normal(size=(Bh, H, W, hd)).astype(np.float32)
               for _ in range(3))
    i_pre = (rng.normal(size=(Bh, H, W)) * 3).astype(np.float32)
    f_log = np.log(1 / (1 + np.exp(-rng.normal(size=(Bh, H, W)) * 2))
                   ).astype(np.float32)
    C = rng.normal(size=(Bh, H, hd, hd)).astype(np.float32)
    n = rng.normal(size=(Bh, H, hd)).astype(np.float32)
    m = rng.normal(size=(Bh, H)).astype(np.float32)
    args = (q, k, v, i_pre, f_log, C, n, m)
    h_r, carry_r = r_ssm._mlstm_chunk_body(*map(jnp.asarray, args), W=W)
    h_t, carry_t = t_ssm._mlstm_chunk_body(*map(torch.from_numpy, args), W=W)
    np.testing.assert_allclose(_np(h_t), _np(h_r), **TOL)
    for got, want in zip(carry_t, carry_r):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_its_own_recurrent_scan(with_state, rng):
    r_cfg, t_cfg = _cfgs()
    _, t_p = _params("mlstm", r_cfg, seed=2)
    x = torch.from_numpy(_x(rng, 128, r_cfg.d_model))
    st = _state("mlstm", rng, r_cfg, t_cfg)[1] if with_state else None
    got = t_ssm.mlstm_apply_chunked(t_p, x, t_cfg, chunk=64, state=st)
    want = t_ssm.mlstm_apply(t_p, x, t_cfg, state=st)
    _check(got, want)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply_matches_reference(with_state, rng):
    r_cfg, t_cfg = _cfgs()
    r_p, t_p = _params("slstm", r_cfg, seed=3)
    x = _x(rng, 12, r_cfg.d_model)
    r_st, t_st = (_state("slstm", rng, r_cfg, t_cfg) if with_state
                  else (None, None))
    want = r_ssm.slstm_apply(r_p, jnp.asarray(x), r_cfg, state=r_st)
    got = t_ssm.slstm_apply(t_p, torch.from_numpy(x), t_cfg, state=t_st)
    _check(got, want)


def test_slstm_first_step_from_the_sentinel_forgets_exactly(rng):
    """From the initial state (m = -1e30 in float32) the forget gate of
    the first step is exactly 0, so whatever c and n hold is dropped: the
    new state is (z, 1, i) bit for bit, as in the reference."""
    r_cfg, t_cfg = _cfgs()
    r_p, t_p = _params("slstm", r_cfg, seed=4)
    x = _x(rng, 1, r_cfg.d_model)
    t_st = t_ssm.xlstm_init_state(t_cfg, B, "slstm")
    assert t_st["m"].dtype == torch.float32
    assert (t_st["m"] == np.float32(-1e30)).all()
    garbage = dict(t_st, c=torch.full_like(t_st["c"], 1e6),
                   n=torch.full_like(t_st["n"], 7.0))
    _, clean = t_ssm.slstm_apply(t_p, torch.from_numpy(x), t_cfg, state=t_st)
    _, dirty = t_ssm.slstm_apply(t_p, torch.from_numpy(x), t_cfg,
                                 state=garbage)
    for k in ("c", "n", "m"):
        assert torch.equal(clean[k], dirty[k]), k
    assert torch.equal(clean["n"], torch.ones_like(clean["n"]))
    z = torch.tanh(torch.from_numpy(x[:, 0]) @ t_p["wz"]["w"] + t_p["wz"]["b"])
    torch.testing.assert_close(clean["c"], z, rtol=1e-6, atol=1e-6)
    _, want = r_ssm.slstm_apply(r_p, jnp.asarray(x), r_cfg,
                                state=r_ssm.xlstm_init_state(r_cfg, B, "slstm"))
    _check((clean["c"], clean), (want["c"], want))


def test_xlstm_block_kind_matches_reference():
    """The full config's 12 layers: s, m, m, m three times."""
    r_cfg, t_cfg = r_configs.get(ARCH), t_configs.get(ARCH)
    kinds = [t_ssm.xlstm_block_kind(i, t_cfg) for i in range(t_cfg.n_layers)]
    assert kinds == [r_ssm.xlstm_block_kind(i, r_cfg)
                     for i in range(r_cfg.n_layers)]
    assert kinds == ["slstm", "mlstm", "mlstm", "mlstm"] * 3


@pytest.mark.parametrize("arch_get", ["get", "get_smoke"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_init_state_matches_reference(kind, arch_get):
    r_cfg = getattr(r_configs, arch_get)(ARCH)
    t_cfg = getattr(t_configs, arch_get)(ARCH)
    want = r_ssm.xlstm_init_state(r_cfg, 3, kind)
    got = t_ssm.xlstm_init_state(t_cfg, 3, kind)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("kind", ["mlstm", "chunked", "slstm"])
def test_bf16_blocks_match_reference(kind, rng):
    """bfloat16 params and activations at smoke widths, as the full
    config runs.  Both packages round at the same places (q, k, v, k's
    1/sqrt(hd) scale, h before the output projection, the output) and
    compute the gates and scans in float32 from the same bfloat16
    values; a float32 sum in another order can flip one rounding, a
    bfloat16 step (2^-8 relative) that later products carry on.
    Allowed: rtol 1e-2 and atol 1e-2 max|ref| (a few such steps); on
    this CPU the two agree bit for bit."""
    r_cfg, t_cfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    r_p, t_p = _params("slstm" if kind == "slstm" else "mlstm", r_cfg,
                       seed=5, dtype=jnp.bfloat16)
    x = _x(rng, 32, r_cfg.d_model)
    xr, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    if kind == "chunked":
        want = r_ssm.mlstm_apply_chunked(r_p, xr, r_cfg, chunk=8)
        got = t_ssm.mlstm_apply_chunked(t_p, xt, t_cfg, chunk=8)
    else:
        want = getattr(r_ssm, f"{kind}_apply")(r_p, xr, r_cfg)
        got = getattr(t_ssm, f"{kind}_apply")(t_p, xt, t_cfg)
    assert got[0].dtype == torch.bfloat16
    scale = np.abs(_np(want[0])).max()
    _check(got, want, dict(rtol=1e-2, atol=1e-2 * scale))


@pytest.mark.parametrize("chunk,T,chunked", [
    (None, 8, False),   # the default: the exact recurrent scan
    (4, 8, True),       # T > MLSTM_CHUNK: chunks of 4
    (8, 8, False),      # T = MLSTM_CHUNK: recurrent
    (4, 1, False),      # a decode step: recurrent
])
def test_xlstm_forward_takes_chunks_only_past_mlstm_chunk(chunk, T, chunked,
                                                          monkeypatch, rng):
    """``xlstm_forward`` sends every mLSTM layer (3 of the smoke config's
    4) through ``mlstm_apply_chunked`` exactly when ``MLSTM_CHUNK`` is set
    and the call is longer than it, as the reference does."""
    from repro_torch.models import transformer as t_transformer

    calls, apply = [], t_ssm.mlstm_apply_chunked

    def spy(*args, chunk, **kw):
        calls.append(chunk)
        return apply(*args, chunk=chunk, **kw)

    monkeypatch.setattr(t_ssm, "mlstm_apply_chunked", spy)
    t_ssm.MLSTM_CHUNK = chunk
    cfg = t_configs.get_smoke(ARCH)
    params = t_transformer.xlstm_init(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T))).long()
    logits = t_transformer.xlstm_forward(params, tokens, cfg)
    assert logits.shape == (B, T, cfg.vocab)
    assert calls == ([chunk] * 3 if chunked else [])


# -- the Mamba (S6) mixer ------------------------------------------------------

JAMBA = "jamba-1.5-large-398b"


def _mamba_cfgs(**changes):
    r_cfg, t_cfg = r_configs.get_smoke(JAMBA), t_configs.get_smoke(JAMBA)
    if changes:
        r_cfg = dataclasses.replace(r_cfg, **changes)
        t_cfg = dataclasses.replace(t_cfg, **changes)
    return r_cfg, t_cfg


def _mamba_params(r_cfg, seed=0, dtype=jnp.float32):
    p = r_ssm.mamba_init(jax.random.PRNGKey(seed), r_cfg, dtype)
    return p, jax.tree_util.tree_map(_torch, p)


def _mamba_state(rng, r_cfg, t_cfg):
    """A carried state as after some steps: conv rows and an ssm state
    of random values, the same for both packages."""
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in
              t_ssm.mamba_init_state(t_cfg, B).items()}
    want = {k: (v.shape, jnp.dtype(v.dtype).name) for k, v in
            r_ssm.mamba_init_state(r_cfg, B).items()}
    assert {k: (s, str(d).removeprefix("torch.")) for k, (s, d)
            in shapes.items()} == want
    st = {k: rng.normal(size=s).astype(np.float32) for k, (s, _)
          in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v) for k, v in st.items()})


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 2, 12])
def test_causal_conv_matches_reference(T, with_state, rng):
    """Output and new state (the last K-1 rows of [state, x]) for T = 1
    and 2, below K-1 = 3, and T = 12; the new state is a copy, not a
    view of the padded input."""
    K, C = 4, 6
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    w = rng.normal(size=(K, C)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    st = rng.normal(size=(B, K - 1, C)).astype(np.float32) if with_state \
        else None
    want = r_ssm._causal_conv(*map(jnp.asarray, (x, w, b)),
                              None if st is None else jnp.asarray(st))
    got = t_ssm._causal_conv(*map(torch.from_numpy, (x, w, b)),
                             None if st is None else torch.from_numpy(st))
    for g, r in zip(got, want):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(_np(g), _np(r), **TOL)
    assert got[1]._base is None


@pytest.mark.parametrize("T,with_state", [
    (12, False), (12, True),
    (1, True),          # a decode step
    (2, False),         # shorter than the conv's K-1 = 3
])
def test_mamba_apply_matches_reference(T, with_state, rng):
    r_cfg, t_cfg = _mamba_cfgs()
    r_p, t_p = _mamba_params(r_cfg)
    x = _x(rng, T, r_cfg.d_model)
    r_st, t_st = (_mamba_state(rng, r_cfg, t_cfg) if with_state
                  else (None, None))
    want = r_ssm.mamba_apply(r_p, jnp.asarray(x), r_cfg, state=r_st)
    got = t_ssm.mamba_apply(t_p, torch.from_numpy(x), t_cfg, state=t_st)
    y_t, s_t = got
    np.testing.assert_allclose(_np(y_t), _np(want[0]), **TOL)
    if with_state:
        assert s_t["ssm"].dtype == torch.float32
        assert s_t["conv"].dtype == torch.float32   # the compute dtype
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(_np(s_t[k]), _np(want[1][k]), **TOL,
                                       err_msg=k)
    else:
        assert s_t is None and want[1] is None


def test_mamba_stateful_equals_stateless(rng):
    """Port only: one step at a time through the carried state gives the
    stateless call's outputs (the reference's
    ``test_mamba_stateful_equals_stateless``), here at the decoders' 2e-4
    since both runs sum in the same order."""
    _, t_cfg = _mamba_cfgs()
    p = t_ssm.mamba_init(torch.Generator().manual_seed(0), t_cfg,
                         torch.float32)
    x = torch.from_numpy(_x(rng, 6, t_cfg.d_model))
    full, none = t_ssm.mamba_apply(p, x, t_cfg)
    assert none is None
    st = t_ssm.mamba_init_state(t_cfg, B)
    ys = []
    for t in range(x.shape[1]):
        y, st = t_ssm.mamba_apply(p, x[:, t:t + 1], t_cfg, state=st)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, dim=1), full, **TOL)


def test_mamba_leaves_the_state_passed_in_unchanged(rng):
    r_cfg, t_cfg = _mamba_cfgs()
    _, t_p = _mamba_params(r_cfg, seed=1)
    _, st = _mamba_state(rng, r_cfg, t_cfg)
    before = {k: v.clone() for k, v in st.items()}
    _, new = t_ssm.mamba_apply(t_p, torch.from_numpy(_x(rng, 5, 64)), t_cfg,
                               state=st)
    for k in st:
        assert torch.equal(st[k], before[k]), k
        assert not torch.equal(new[k], before[k]), k


def test_bf16_mamba_matches_reference(rng):
    """bfloat16 params and activations at smoke widths, as the full
    config runs.  Both packages round at the same places (the
    projections, the conv's output, silu's, y before the output
    projection) and run the scan in float32 from the same bfloat16
    values; a float32 sum in another order can flip one rounding, a
    bfloat16 step (2^-8 relative) that later products carry on.
    Allowed, as for the xLSTM's blocks: rtol 1e-2 and atol 1e-2
    max|ref|."""
    r_cfg, t_cfg = _mamba_cfgs(param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    r_p, t_p = _mamba_params(r_cfg, seed=5, dtype=jnp.bfloat16)
    assert t_p["A_log"].dtype == t_p["D"].dtype == torch.float32
    x = _x(rng, 32, r_cfg.d_model)
    xr, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    r_st = r_ssm.mamba_init_state(r_cfg, B)
    t_st = t_ssm.mamba_init_state(t_cfg, B)
    assert t_st["conv"].dtype == torch.bfloat16
    want = r_ssm.mamba_apply(r_p, xr, r_cfg, state=r_st)
    got = t_ssm.mamba_apply(t_p, xt, t_cfg, state=t_st)
    assert got[0].dtype == torch.bfloat16
    scale = np.abs(_np(want[0])).max()
    tol = dict(rtol=1e-2, atol=1e-2 * scale)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **tol)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(
            _np(got[1][k]), _np(want[1][k]), rtol=1e-2,
            atol=1e-2 * np.abs(_np(want[1][k])).max(), err_msg=k)


@pytest.mark.parametrize("arch_get", ["get", "get_smoke"])
def test_mamba_init_and_state_are_shaped_like_the_reference(arch_get):
    """``mamba_init`` on meta against ``jax.eval_shape`` of the
    reference's (dt_rank 512 and d_in 16,384 at the full config), and
    ``mamba_init_state`` equal to the reference's zeros; A_log is
    log(1..S) in float32 on every channel and D is ones."""
    r_cfg = getattr(r_configs, arch_get)(JAMBA)
    t_cfg = getattr(t_configs, arch_get)(JAMBA)
    want = jax.eval_shape(lambda k: r_ssm.mamba_init(k, r_cfg, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    got = t_ssm.mamba_init(None, t_cfg, torch.bfloat16, device="meta")
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name, path
    if arch_get == "get":
        assert got["x_proj"]["w"].shape == (16384, 512 + 32)
    st_r, st_t = (r_ssm.mamba_init_state(r_cfg, 3),
                  t_ssm.mamba_init_state(t_cfg, 3, device="meta"))
    for k in st_r:
        assert tuple(st_t[k].shape) == st_r[k].shape, k
        assert str(st_t[k].dtype).removeprefix("torch.") == st_r[k].dtype.name
    small = t_ssm.mamba_init(torch.Generator().manual_seed(0),
                             t_configs.get_smoke(JAMBA), torch.float32,
                             lead=(2,))
    ref = r_ssm.mamba_init(jax.random.PRNGKey(0), r_configs.get_smoke(JAMBA),
                           jnp.float32)
    for k in ("A_log", "D"):
        assert small[k].shape == (2, *ref[k].shape)
        np.testing.assert_array_equal(small[k][1].numpy(), np.asarray(ref[k]))


# -- the step loops' backward ----------------------------------------------------

#: the lengths the backward's bytes are counted at, and the most a
#: doubling of T may multiply them by: a loop that reads its steps as
#: one ``unbind``'s views writes O(T) bytes (a ``select`` a step wrote a
#: zero gradient of the whole sequence each step: 2.5-3.6x a doubling)
BYTES_T = (16, 32, 64)
BYTES_GROWTH = 2.2


class _Written(TorchDispatchMode):
    """The bytes of every result of an op that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in torch.utils._pytree.tree_leaves(out)
                              if isinstance(t, torch.Tensor))
        return out


def _loop(kind):
    """(reference apply, port apply, reference params, port params, d)."""
    if kind == "mamba":
        r_cfg, t_cfg = _mamba_cfgs()
        r_p, t_p = _mamba_params(r_cfg, seed=7)
        return (lambda p, x: r_ssm.mamba_apply(p, x, r_cfg),
                lambda p, x: t_ssm.mamba_apply(p, x, t_cfg), r_p, t_p,
                r_cfg.d_model)
    r_cfg, t_cfg = _cfgs()
    r_p, t_p = _params("slstm" if kind == "slstm" else "mlstm", r_cfg,
                       seed=7)
    if kind == "chunked":
        return (lambda p, x: r_ssm.mlstm_apply_chunked(p, x, r_cfg, chunk=8),
                lambda p, x: t_ssm.mlstm_apply_chunked(p, x, t_cfg, chunk=8),
                r_p, t_p, r_cfg.d_model)
    r_fn = r_ssm.slstm_apply if kind == "slstm" else r_ssm.mlstm_apply
    t_fn = t_ssm.slstm_apply if kind == "slstm" else t_ssm.mlstm_apply
    return (lambda p, x: r_fn(p, x, r_cfg), lambda p, x: t_fn(p, x, t_cfg),
            r_p, t_p, r_cfg.d_model)


@pytest.mark.parametrize("kind", ["mlstm", "chunked", "slstm", "mamba"])
def test_step_loop_backward_writes_bytes_linear_in_T(kind, rng):
    """``mlstm_apply``, ``mlstm_apply_chunked`` (W = 8), ``slstm_apply``
    and ``mamba_apply`` at smoke widths, T = 16, 32, 64: the bytes the
    backward writes (a dispatch mode over ``torch.autograd.backward``)
    grow at most :data:`BYTES_GROWTH` times a doubling of T; at T = 16
    the outputs and the gradients of x and of every param equal the
    reference's (``jax.vjp``, the same cotangent) within :data:`TOL`."""
    r_fn, t_fn, r_p, t_p, d = _loop(kind)
    written = []
    for T in BYTES_T:
        x, g = _x(rng, T, d), _x(rng, T, d)
        leaves = torch.utils._pytree.tree_leaves(t_p)
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        got, _ = t_fn(t_p, xt)
        mode = _Written()
        with mode:
            torch.autograd.backward(got, torch.from_numpy(g))
        written.append(mode.bytes)
        for t in leaves:
            t.requires_grad_(False)
        if T > BYTES_T[0]:
            continue
        want, vjp = jax.vjp(lambda p, x: r_fn(p, x)[0], r_p, jnp.asarray(x))
        want_p, want_x = vjp(jnp.asarray(g))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(_np(xt.grad), _np(want_x), **TOL)
        jax.tree_util.tree_map(
            lambda w, t: np.testing.assert_allclose(_np(t.grad), _np(w),
                                                    **TOL), want_p, t_p)
    for a, b in zip(written, written[1:]):
        assert b <= BYTES_GROWTH * a, written
