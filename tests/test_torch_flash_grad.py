"""Gradients of the port's attention held against the reference's.

The reference differentiates attention through ``flash_attention_xla``'s
custom VJP (``xla_flash.py``; its Pallas kernel has no derivative, see
``test_reference_pallas_kernel_has_no_gradient``).  The port's
``xla_flash`` is held against it forward and backward (``jax.vjp``), and
so are the autograd of ``impl="pallas"`` and ``impl="interpret"`` on the
CPU, which run the flash kernels' plain forward and backward
(``ref.flash_attention_plain`` with its LSE, ``flash_attention_bwd_plain``).
Inputs are seeded numpy normals.

Tolerances: float32 within rtol 2e-5 / atol 2e-5 max|ref| (both sides
sum in float32 in other orders; the reference's kernel tests use 2e-5);
bfloat16 (``xla_flash`` on both sides: the same bfloat16 inputs, float32
scores and sums, p rounded to bfloat16 for PV, each result rounded once)
within rtol 2^-7 / atol 2^-7 max|ref|: one bfloat16 step where the two
float32 values straddle a rounding boundary, which can also tip a p to
its other bfloat16 neighbour.  The card's kernels are held against these
plain versions in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as r_ops
from repro.kernels.attention.xla_flash import flash_attention_xla as r_flash
from repro_torch.core import precision as t_prec
from repro_torch.kernels.attention import ops as t_ops
from repro_torch.kernels.attention import ref as t_ref
from repro_torch.kernels.attention import xla_flash as t_xf

F32 = dict(rtol=2e-5, frac=2e-5)
BF16 = dict(rtol=2 ** -7, frac=2 ** -7)

CASES = [
    # B, Hq, Hkv, Tq, Tk, d, causal
    (1, 4, 2, 64, 64, 16, True),      # GQA 4:2
    (1, 4, 2, 64, 64, 16, False),
    (2, 4, 2, 32, 64, 64, True),      # Tq < Tk, end-aligned
    (1, 4, 2, 32, 64, 64, False),
]


def _inputs(rng, B, Hq, Hkv, Tq, Tk, d):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Tq, d), (B, Hkv, Tk, d), (B, Hkv, Tk, d),
                      (B, Hq, Tq, d))]


def _close(got, want, rtol, frac, what=""):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * np.abs(want).max(), err_msg=what)


def _ref_vjp(q, k, v, do, causal, dtype, chunk):
    cast = lambda a: jnp.asarray(a, dtype)
    o, vjp = jax.vjp(
        lambda q, k, v: r_flash(q, k, v, causal=causal, chunk=chunk),
        cast(q), cast(k), cast(v))
    return [np.asarray(x.astype(jnp.float32))
            for x in (o, *vjp(cast(do)))]


def _port_grads(fn, q, k, v, do, dtype):
    t = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = fn(*t)
    grads = torch.autograd.grad(o, t, torch.from_numpy(do).to(dtype))
    return [x.float().numpy() for x in (o.detach(), *grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_xla_flash_forward_and_vjp_match_reference(case, dtype, rng):
    B, Hq, Hkv, Tq, Tk, d, causal = case
    q, k, v, do = _inputs(rng, B, Hq, Hkv, Tq, Tk, d)
    want = _ref_vjp(q, k, v, do, causal, getattr(jnp, dtype), chunk=16)
    got = _port_grads(
        lambda q, k, v: t_xf.flash_attention_xla(q, k, v, causal=causal,
                                                 chunk=16),
        q, k, v, do, getattr(torch, dtype))
    tol = F32 if dtype == "float32" else BF16
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        _close(g, w, **tol, what=name)


def test_xla_flash_chunk_rules_match_reference(rng):
    """The default chunk cut to Tk, and a chunk that does not divide Tk
    falling back to one chunk, as in the reference."""
    q, k, v, do = _inputs(rng, 1, 2, 1, 48, 48, 16)
    for chunk in (None, 32):
        want = _ref_vjp(q, k, v, do, True, jnp.float32, chunk=chunk)
        got = _port_grads(
            lambda q, k, v: t_xf.flash_attention_xla(q, k, v, chunk=chunk),
            q, k, v, do, torch.float32)
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            _close(g, w, **F32, what=f"chunk {chunk}: {name}")


@pytest.mark.parametrize("impl", ["pallas", "interpret", "xla", "xla_flash"])
@pytest.mark.parametrize("case", CASES)
def test_every_impl_differentiates_like_reference_xla_flash(case, impl, rng):
    B, Hq, Hkv, Tq, Tk, d, causal = case
    q, k, v, do = _inputs(rng, B, Hq, Hkv, Tq, Tk, d)
    want = _ref_vjp(q, k, v, do, causal, jnp.float32, chunk=1024)
    got = _port_grads(
        lambda q, k, v: t_ops.multi_head_attention(
            q, k, v, causal=causal, impl=impl, block_q=16, block_k=32),
        q, k, v, do, torch.float32)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        _close(g, w, **F32, what=f"{impl}: {name}")


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_autograd_of_plain_attention(case, rng):
    """flash_attention_bwd_plain from the plain forward's (o, lse) against
    torch.autograd through ``_xla_attention`` (whole-tensor softmax)."""
    B, Hq, Hkv, Tq, Tk, d, causal = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(rng, B, Hq, Hkv, Tq,
                                                       Tk, d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = t_ops._xla_attention(*leaves, causal=causal, scale=d ** -0.5)
    want = torch.autograd.grad(out, leaves, do)
    fold = lambda t, H: t.reshape(B * H, t.shape[2], d)
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal)
    o, lse = t_ref.flash_attention_plain(fold(q, Hq), fold(k, Hkv),
                                         fold(v, Hkv), return_lse=True, **kw)
    assert lse.shape == (B * Hq, Tq) and lse.dtype == torch.float32
    got = t_ref.flash_attention_bwd_plain(fold(q, Hq), fold(k, Hkv),
                                          fold(v, Hkv), o, lse, fold(do, Hq),
                                          **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.reshape(w.shape), w, **F32, what=name)


def test_bwd_plain_refuses_more_queries_than_keys():
    q = torch.zeros(2, 32, 16)
    k = torch.zeros(1, 16, 16)
    lse = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        t_ref.flash_attention_bwd_plain(q, k, k, q, lse, q, n_q_heads=2,
                                        n_kv_heads=1)


def test_lse_is_the_row_log_sum_exp(rng):
    B, Hq, Hkv, T, d = 1, 2, 1, 64, 16
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(rng, B, Hq, Hkv, T, T,
                                                      d))
    qf, kf, vf = q[0], k[0], v[0]
    _, lse = t_ref.flash_attention_plain(qf, kf, vf, n_q_heads=Hq,
                                         n_kv_heads=Hkv, return_lse=True)
    s = (qf @ kf[0].T) * d ** -0.5
    s = torch.where(torch.ones(T, T).tril().bool(), s, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("b_shape", [(16, 8), (3, 16, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_f32_function_backward_on_cpu(dtype, b_shape):
    """The card's differentiable product, forced onto CPU tensors, against
    autograd of the upcast path: float32 operands bitwise; bfloat16 ones
    after rounding the cotangent to bfloat16, as the Function does."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(3, 5, 16, generator=gen).to(dtype).requires_grad_()
    b = torch.randn(*b_shape, generator=gen).to(dtype).requires_grad_()
    out = t_prec._MatmulF32.apply(a, b)
    g = torch.randn(out.shape, generator=gen)
    da, db = torch.autograd.grad(out, (a, b), g)
    assert out.dtype == torch.float32 and da.dtype == db.dtype == dtype
    a2, b2 = (x.detach().requires_grad_() for x in (a, b))
    out2 = torch.matmul(a2.float(), b2.float())
    da2, db2 = torch.autograd.grad(out2, (a2, b2), g.to(dtype).float())
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    # both sum the same float32 products; the upcast path rounds once at
    # its .float() backward, like the Function's final cast
    torch.testing.assert_close(da.float(), da2.float(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(db.float(), db2.float(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "jamba-1.5-large-398b",
                                  "whisper-tiny"])
def test_remat_block_gives_bitwise_the_gradients_of_none(arch, rng):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.runtime.train import make_loss_fn, value_and_grad

    cfg = configs.get_smoke(arch)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    out = {}
    for remat in ("block", "none"):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            device="cpu")
        out[remat] = value_and_grad(make_loss_fn(model), params, batch)
    from repro_torch.tree import tree_leaves

    assert torch.equal(out["block"][0], out["none"][0])
    for a, b in zip(tree_leaves(out["block"][1]), tree_leaves(out["none"][1])):
        assert torch.equal(a, b)


def test_remat_block_recomputes_each_block_once_in_the_backward(
        monkeypatch, rng):
    """At remat="block" the backward runs every decoder block's forward
    once more (2 L calls a step); at "none", and in a forward without
    gradients, L calls."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build_model, transformer
    from repro_torch.runtime.train import make_loss_fn, value_and_grad

    calls = []
    real = transformer.block_apply
    monkeypatch.setattr(transformer, "block_apply",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = configs.get_smoke("internlm2-1.8b")
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))}
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    for remat, want in (("block", 2), ("none", 1)):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            device="cpu")
        calls.clear()
        value_and_grad(make_loss_fn(model), params, batch)
        assert len(calls) == want * cfg.n_layers, remat
    calls.clear()
    build_model(cfg, device="cpu").forward(params, batch)
    assert len(calls) == cfg.n_layers


def test_reference_pallas_kernel_has_no_gradient(rng):
    """ROADMAP fault 15: jax.grad through the reference's Pallas kernel (in
    interpret mode here) fails; its only flash backward is xla_flash's
    custom VJP, which the port's backward kernel takes for its model."""
    q, k, v, _ = _inputs(rng, 1, 2, 1, 32, 32, 16)

    def loss(q):
        return r_ops.multi_head_attention(
            q, jnp.asarray(k), jnp.asarray(v), impl="interpret", block_q=16,
            block_k=16).sum()

    with pytest.raises(AssertionError):
        jax.grad(loss)(jnp.asarray(q))
