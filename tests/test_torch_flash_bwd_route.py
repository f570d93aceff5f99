"""The flash backward's two routes, held on the CPU.

The backward kernels split by storage dtype and head dim as the forward's
do (``ref.route``): ``"wgmma"`` (bfloat16 at head dims 64 and 128,
``csrc/flash_attention_bwd_sm90.cu``, tensor cores) and ``"fma"`` (float32
at 16/32/64/128 and bfloat16 at 16 and 32, ``csrc/flash_attention_bwd.cu``,
CUDA cores).  Their plain version ``flash_attention_bwd_plain`` repeats the
arithmetic of the route's kernel, and that is what these tests hold:

* on the fma route it is bitwise the all-float32 arithmetic
  (:func:`_bwd_f32`, the plain backward as it stood before the
  tensor-core route: ``p`` and ``ds`` never rounded);
* on the wgmma route it rounds ``p`` to bfloat16 for dv and ``ds`` (from
  the float32 ``p``) for dq and dk, and so differs from the float32
  arithmetic by at most one bfloat16 rounding of each ``p`` and ``ds``,
  2^-8 relative, carried through the float32 sums -- ``2^-8 |p|^T |do|``
  for dv, ``2^-8 |ds| |k|`` for dq, ``2^-8 |ds|^T |q|`` for dk -- plus the
  final rounding of each side to bfloat16, 2^-8 of each side's magnitude;
* it stays within ``tests/test_torch_flash_grad.py``'s bfloat16 bounds
  (rtol 2^-7, atol 2^-7 max|ref|) of the reference's ``xla_flash`` VJP in
  bfloat16 (which keeps ``p`` and ``ds`` in float32): the worst element
  of each gradient reaches 0.30-0.43 of that bound on the cases below;
* the wrapper's route choice and its refusals, which come before any
  launch and so show on the CPU.

Inputs are seeded numpy normals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.xla_flash import flash_attention_xla as r_flash
from repro_torch.kernels.attention import attention as t_attn
from repro_torch.kernels.attention import ref as t_ref

#: one bfloat16 rounding, relative (8 significant bits)
U_BF16 = 2.0 ** -8


def _inputs(rng, B, Hq, Hkv, Tq, Tk, d, dtype):
    """Head-folded (q, k, v, do) in ``dtype``."""
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(dtype)
                   for s in ((B * Hq, Tq, d), (B * Hkv, Tk, d),
                             (B * Hkv, Tk, d), (B * Hq, Tq, d)))
    return q, k, v, do


def _bwd_f32(q, k, v, o, lse, do, *, n_q_heads, n_kv_heads, causal, scale):
    """The backward in float32 throughout, as the plain version computed it
    for every dtype before the tensor-core route: returns float32 ``(dq,
    dk, dv)`` (not rounded to the storage dtype) and the per-element bound
    of one bfloat16 rounding of every ``p`` and ``ds``."""
    G, Tq, d = q.shape
    Gkv, Tk, _ = k.shape
    group = n_q_heads // n_kv_heads
    f32 = torch.float32
    rows = group * Tq
    qf = q.to(f32).reshape(Gkv, rows, d)
    dof = do.to(f32).reshape(Gkv, rows, d)
    kf, vf = k.to(f32), v.to(f32)
    lse_f = lse.to(f32).reshape(Gkv, rows, 1)
    delta = (dof * o.to(f32).reshape(Gkv, rows, d)).sum(dim=2, keepdim=True)
    qpos = (torch.arange(Tq) + (Tk - Tq)).repeat(group)
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    b_dq = torch.zeros_like(qf)
    b_dk = torch.empty_like(kf)
    b_dv = torch.empty_like(vf)
    T = t_ref.TILE_K
    for k0 in range(0, Tk, T):
        kt, vt = kf[:, k0:k0 + T], vf[:, k0:k0 + T]
        p = torch.exp(torch.matmul(qf, kt.transpose(1, 2)) * scale - lse_f)
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[1])
            p = torch.where(qpos[:, None] >= kpos[None, :], p, 0.0)
        dv[:, k0:k0 + T] = torch.matmul(p.transpose(1, 2), dof)
        dp = torch.matmul(dof, vt.transpose(1, 2))
        ds = p * (dp - delta) * scale
        dq += torch.matmul(ds, kt)
        dk[:, k0:k0 + T] = torch.matmul(ds.transpose(1, 2), qf)
        b_dv[:, k0:k0 + T] = U_BF16 * torch.matmul(p.abs().transpose(1, 2),
                                                   dof.abs())
        b_dq += U_BF16 * torch.matmul(ds.abs(), kt.abs())
        b_dk[:, k0:k0 + T] = U_BF16 * torch.matmul(ds.abs().transpose(1, 2),
                                                   qf.abs())
    return ((dq.reshape(G, Tq, d), dk, dv),
            (b_dq.reshape(G, Tq, d), b_dk, b_dv))


FMA_CASES = [
    # B, Hq, Hkv, Tq, Tk, d, causal, dtype
    (1, 4, 2, 64, 64, 16, True, torch.float32),
    (2, 2, 1, 40, 72, 64, True, torch.float32),
    (1, 2, 2, 48, 80, 128, False, torch.float32),
    (1, 4, 1, 72, 72, 16, True, torch.bfloat16),
    (2, 2, 2, 24, 96, 32, False, torch.bfloat16),
]

WGMMA_CASES = [
    (1, 4, 2, 64, 64, 64, True),
    (2, 2, 1, 40, 72, 64, False),
    (1, 2, 1, 72, 136, 128, True),
]


@pytest.mark.parametrize("case", FMA_CASES)
def test_fma_route_plain_bwd_is_the_float32_arithmetic_bitwise(case, rng):
    B, Hq, Hkv, Tq, Tk, d, causal, dtype = case
    assert t_ref.route(dtype, d) == "fma"
    q, k, v, do = _inputs(rng, B, Hq, Hkv, Tq, Tk, d, dtype)
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal, scale=d ** -0.5)
    o, lse = t_ref.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = t_ref.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    want, _ = _bwd_f32(q, k, v, o, lse, do, **kw)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype
        assert torch.equal(g, w.to(x.dtype))


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_wgmma_route_plain_bwd_within_one_rounding_of_p_and_ds(case, rng):
    """bfloat16 at d 64/128: within the bound of one bfloat16 rounding of
    every p and ds of the float32 arithmetic, plus each side's final
    rounding, and not equal to it (the rounding is there)."""
    B, Hq, Hkv, Tq, Tk, d, causal = case
    dtype = torch.bfloat16
    assert t_ref.route(dtype, d) == "wgmma"
    q, k, v, do = _inputs(rng, B, Hq, Hkv, Tq, Tk, d, dtype)
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal, scale=d ** -0.5)
    o, lse = t_ref.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = t_ref.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    want, bound = _bwd_f32(q, k, v, o, lse, do, **kw)
    differs = False
    for name, g, w, b in zip(("dq", "dk", "dv"), got, want, bound):
        g = g.float()
        w_out = w.to(dtype).float()
        limit = (b + U_BF16 * (g.abs() + w.abs()) * (1 + U_BF16)
                 + 1e-6 * w.abs().max())
        err = (g - w_out).abs()
        assert (err <= limit).all(), (
            f"{name}: max excess {(err - limit).max().item():.3e}")
        differs |= not torch.equal(g, w_out)
    assert differs


REF_CASES = [
    # B, Hq, Hkv, Tq, Tk, d, causal
    (2, 4, 2, 32, 64, 64, True),
    (1, 4, 2, 64, 64, 64, False),
    (1, 2, 1, 64, 64, 128, True),
]


@pytest.mark.parametrize("case", REF_CASES)
def test_wgmma_route_plain_bwd_within_bf16_bounds_of_reference_xla_flash(
        case, rng):
    """The port's plain forward and backward on the wgmma route (p rounded
    for PV, p for dv, ds for dq and dk) against the reference's
    ``xla_flash`` VJP in bfloat16, within rtol 2^-7 / atol 2^-7
    max|ref| (``test_torch_flash_grad.BF16``)."""
    B, Hq, Hkv, Tq, Tk, d, causal = case
    shapes = ((B, Hq, Tq, d), (B, Hkv, Tk, d), (B, Hkv, Tk, d),
              (B, Hq, Tq, d))
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in shapes)
    cast = lambda a: jnp.asarray(a, jnp.bfloat16)
    _, vjp = jax.vjp(lambda q, k, v: r_flash(q, k, v, causal=causal,
                                             chunk=1024),
                     cast(q), cast(k), cast(v))
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(cast(do))]
    fold = lambda a, H: torch.from_numpy(a).to(torch.bfloat16).reshape(
        B * H, a.shape[2], d)
    tq, tk, tv, tdo = (fold(q, Hq), fold(k, Hkv), fold(v, Hkv), fold(do, Hq))
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal)
    assert t_ref.route(tq.dtype, d) == "wgmma"
    o, lse = t_ref.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = t_ref.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.float().numpy().reshape(w.shape)
        np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "fma"), (torch.bfloat16, 32, "fma"),
    (torch.float32, 16, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"),
])
def test_bwd_route_follows_the_forward_split(dtype, d, want, rng):
    q, k, v, do = _inputs(rng, 2, 2, 1, 32, 48, d, dtype)
    lse = torch.zeros(4, 32)
    kw = dict(n_q_heads=2, n_kv_heads=1)
    assert t_ref.route(dtype, d) == want
    assert t_attn.bwd_route(q, k, v, q, lse, do, **kw) == want


def _refused(rng):
    """(name, args, error, match): what the backward wrapper refuses."""
    q, k, v, do = _inputs(rng, 1, 2, 1, 64, 64, 64, torch.bfloat16)
    lse = torch.zeros(2, 64)
    short_k = k[:, :32].contiguous()
    q48 = torch.zeros(2, 64, 48, dtype=torch.bfloat16)
    k48 = torch.zeros(1, 64, 48, dtype=torch.bfloat16)
    odd = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 64, 64)
    return [
        ("Tq > Tk", (q, short_k, short_k, q, lse, do), ValueError, "Tq <= Tk"),
        ("o shape", (q, k, v, q[:, :32], lse, do), ValueError, "do not match"),
        ("lse shape", (q, k, v, q, lse[:, :32], do), ValueError, "do not match"),
        ("mixed dtypes", (q, k, v, q, lse, do.float()), TypeError, "one dtype"),
        ("half", (q.half(), k.half(), v.half(), q.half(), lse, do.half()),
         TypeError, "float32 or bfloat16"),
        ("strided do", (q, k, v, q, lse, do.transpose(1, 2).contiguous()
                        .transpose(1, 2)), ValueError, "contiguous"),
        ("unaligned", (odd, k, v, q, lse, do), ValueError, "16-byte"),
        ("lse dtype", (q, k, v, q, lse.double(), do), ValueError, "lse"),
        ("head dim", (q48, k48, k48, q48, lse, q48), ValueError, "head dims"),
    ]


@pytest.mark.parametrize("which", range(9))
def test_bwd_route_refuses_what_no_backward_kernel_takes(which, rng):
    name, args, error, match = _refused(rng)[which]
    with pytest.raises(error, match=match):
        t_attn.bwd_route(*args, n_q_heads=2, n_kv_heads=1)


def test_bwd_wrapper_never_falls_back_off_the_card():
    """The backward's op (``repro_torch::flash_bwd``) refuses tensors on
    a device it has no kernel for (the CPU's, which only the wrapper
    sends to the plain version) after the route is chosen, and counts
    nothing; on ``meta`` tensors the wrapper returns the fake's shapes,
    counts nothing and never runs the plain version."""
    q = torch.empty(2, 64, 64, dtype=torch.bfloat16)
    k = torch.empty(1, 64, 64, dtype=torch.bfloat16)
    lse = torch.empty(2, 64)
    before = dict(t_attn.flash_attention_bwd.launches_by_route)
    n = t_attn.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        torch.ops.repro_torch.flash_bwd(q, k, k, q, lse, q, 2, 1, True, 0.125)
    meta = [t.to("meta") for t in (q, k, lse)]
    got = t_attn.flash_attention_bwd(meta[0], meta[1], meta[1], meta[0],
                                     meta[2], meta[0], n_q_heads=2,
                                     n_kv_heads=1)
    assert [(g.device.type, g.shape, g.dtype) for g in got] == [
        ("meta", t.shape, t.dtype) for t in (q, k, k)]
    assert t_attn.flash_attention_bwd.launches == n
    assert t_attn.flash_attention_bwd.launches_by_route == before
    assert set(before) == {"wgmma", "fma"}


def test_bwd_wrapper_on_cpu_tensors_is_the_plain_version_uncounted(rng):
    q, k, v, do = _inputs(rng, 1, 2, 1, 40, 64, 64, torch.bfloat16)
    kw = dict(n_q_heads=2, n_kv_heads=1, causal=True)
    o, lse = t_ref.flash_attention_plain(q, k, v, return_lse=True, **kw)
    n = t_attn.flash_attention_bwd.launches
    got = t_attn.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = t_ref.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert t_attn.flash_attention_bwd.launches == n
