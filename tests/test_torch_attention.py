"""The port's flash attention held against the reference's.

On the CPU the kernel's wrapper runs its plain PyTorch version, which
repeats the CUDA kernel's online-softmax recurrence; it is compared with
the reference's Pallas kernel in interpret mode and with its jnp oracle
(``attention_ref``), over the reference's own sweep
(``tests/test_kernels.py``).  Inputs are seeded numpy normals, float32.
Tolerance rtol = atol = 2e-5, as the reference's kernel tests use: both
sides sum in float32, in another order.  The kernel-against-plain cases,
which need a CUDA card, are in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as r_ops
from repro.kernels.attention.ref import attention_ref
from repro_torch.kernels.attention import attention as t_attn
from repro_torch.kernels.attention import ops as t_ops
from repro_torch.kernels.attention import ref as t_ref

TOL = dict(rtol=2e-5, atol=2e-5)

SWEEP = [
    # B, Hq, Hkv, Tq, Tk, d, causal  (tests/test_kernels.py)
    (2, 4, 2, 64, 64, 32, True),
    (1, 8, 2, 32, 128, 16, True),     # GQA 4:1, cross-length causal
    (2, 2, 2, 64, 64, 64, False),
    (1, 4, 1, 128, 128, 32, True),    # MQA
    (1, 2, 2, 16, 16, 128, True),
]


def _qkv(rng, B, Hq, Hkv, Tq, Tk, d):
    return (rng.normal(size=(B, Hq, Tq, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, Tk, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, Tk, d)).astype(np.float32))


def _port(q, k, v, **kw):
    return t_ops.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw
    ).numpy()


@pytest.mark.parametrize("case", SWEEP)
def test_plain_matches_reference_kernel_and_oracle(case, rng):
    B, Hq, Hkv, Tq, Tk, d, causal = case
    q, k, v = _qkv(rng, B, Hq, Hkv, Tq, Tk, d)
    kw = dict(causal=causal, block_q=16, block_k=32)
    want = np.asarray(r_ops.multi_head_attention(q, k, v, impl="interpret", **kw))
    oracle = np.asarray(attention_ref(
        q.reshape(B * Hq, Tq, d), k.reshape(B * Hkv, Tk, d),
        v.reshape(B * Hkv, Tk, d), n_q_heads=Hq, n_kv_heads=Hkv,
        causal=causal,
    )).reshape(B, Hq, Tq, d)
    for impl in ("interpret", "pallas"):   # pallas on CPU tensors: plain
        got = _port(q, k, v, impl=impl, **kw)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, oracle, **TOL)


def test_fully_masked_rows_take_the_mean_of_the_visited_values(rng):
    """Tq > Tk, causal: rows 0..Tq-Tk-1 see no key.  With the blocks
    covering every key (the reference kernel's defaults here) the
    reference kernel gives them p = exp(0) = 1 on each key, i.e. the mean
    of V -- and so must the port, neither zero nor NaN."""
    B, Hq, Hkv, Tq, Tk, d = 1, 2, 1, 64, 32, 16
    q, k, v = _qkv(rng, B, Hq, Hkv, Tq, Tk, d)
    want = np.asarray(r_ops.multi_head_attention(q, k, v, impl="interpret"))
    got = _port(q, k, v, impl="interpret")
    np.testing.assert_allclose(got, want, **TOL)
    masked = Tq - Tk
    mean_v = np.repeat(v.mean(axis=2), Hq // Hkv, axis=1)   # (B, Hq, d)
    for row in range(masked):
        np.testing.assert_allclose(got[:, :, row], mean_v, **TOL)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, _port(q, k, v, impl="xla"), **TOL)


@pytest.mark.parametrize("blocks,zero_rows", [
    ((512, 512), 0),     # default blocks: the one query block reaches key 0
    ((64, 64), 128),     # query blocks 0 and 1 end above the keys
])
def test_no_visited_tile_gives_zero(blocks, zero_rows, rng):
    """A row whose query block visits no key block has K_lim = 0: l == 0
    is divided as 1, so it is 0.  Tq = 192, Tk = 64: at the reference's
    default blocks its one query block ends at key 63, so rows 0..127
    see no key but visit key block 0 and come out as the mean of V; at
    64 x 64 blocks query blocks 0 and 1 visit nothing and give 0.  The
    port equals the reference kernel in both cases."""
    B, Hq, Hkv, Tq, Tk, d = 1, 2, 1, 192, 64, 16
    q, k, v = _qkv(rng, B, Hq, Hkv, Tq, Tk, d)
    kw = dict(block_q=blocks[0], block_k=blocks[1])
    want = np.asarray(r_ops.multi_head_attention(q, k, v, impl="interpret", **kw))
    mean_v = np.repeat(v.mean(axis=2), Hq // Hkv, axis=1)[:, :, None]
    for impl in ("interpret", "pallas"):
        got = _port(q, k, v, impl=impl, **kw)
        assert np.isfinite(got).all()
        assert (got[:, :, :zero_rows] == 0).all()
        np.testing.assert_allclose(
            got[:, :, zero_rows:128],
            np.broadcast_to(mean_v, got[:, :, zero_rows:128].shape), **TOL)
        np.testing.assert_allclose(got, want, **TOL)


def test_fully_masked_rows_differ_from_the_reference_at_its_default_blocks(rng):
    """Rows that see no key follow the reference's blocks, not the
    port's tiles.  Tq = 128, Tk = 64, default blocks: the reference's one
    query block (last row at position 63) visits key block 0, so rows
    0..63 are the mean of V -- in the port too, though its first tile of
    64 query rows ends at position -1.  Rows 64..127 see keys."""
    B, Hq, Hkv, Tq, Tk, d = 1, 2, 1, 128, 64, 16
    q, k, v = _qkv(rng, B, Hq, Hkv, Tq, Tk, d)
    want = np.asarray(r_ops.multi_head_attention(q, k, v, impl="interpret"))
    mean_v = np.repeat(v.mean(axis=2), Hq // Hkv, axis=1)[:, :, None]
    np.testing.assert_allclose(want[:, :, :64], np.broadcast_to(
        mean_v, want[:, :, :64].shape), **TOL)
    for impl in ("interpret", "pallas"):
        got = _port(q, k, v, impl=impl)
        np.testing.assert_allclose(got, want, **TOL)


MASKED_SWEEP = [
    # Tq, Tk, block_q, block_k; causal with Tq > Tk, so rows
    # 0..Tq-Tk-1 see no key and their K_lim follows the blocks
    (128, 64, 512, 512),
    (128, 64, 32, 16),
    (192, 64, 64, 32),
    (192, 96, 96, 32),
    (256, 96, 16, 96),
    (160, 40, 32, 8),
]


@pytest.mark.parametrize("case", MASKED_SWEEP)
def test_fully_masked_rows_follow_the_reference_blocks(case, rng):
    Tq, Tk, bq, bk = case
    B, Hq, Hkv, d = 1, 4, 2, 16
    q, k, v = _qkv(rng, B, Hq, Hkv, Tq, Tk, d)
    kw = dict(block_q=bq, block_k=bk)
    want = np.asarray(r_ops.multi_head_attention(q, k, v, impl="interpret", **kw))
    for impl in ("interpret", "pallas"):
        np.testing.assert_allclose(_port(q, k, v, impl=impl, **kw), want, **TOL)


def test_block_size_invariance(rng):
    B, Hq, Hkv, T, d = 1, 2, 1, 128, 32
    q, k, v = _qkv(rng, B, Hq, Hkv, T, T, d)
    outs = [_port(q, k, v, impl="interpret", block_q=bq, block_k=bk)
            for bq, bk in [(16, 16), (32, 64), (128, 128)]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    want = np.asarray(r_ops.multi_head_attention(
        q, k, v, impl="interpret", block_q=32, block_k=64))
    np.testing.assert_allclose(outs[0], want, **TOL)


@pytest.mark.parametrize("fn", [t_attn.flash_attention, t_ref.flash_attention_plain])
def test_blocks_must_divide_the_sequence(fn, rng):
    q = torch.from_numpy(rng.normal(size=(2, 48, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 48, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="not divisible"):
        fn(q, k, k, n_q_heads=2, n_kv_heads=1, block_q=32)
    fn(q, k, k, n_q_heads=2, n_kv_heads=1, block_q=16, block_k=64)  # 48 | 48


@pytest.mark.parametrize("causal", [True, False])
def test_xla_path_matches_reference_xla(causal, rng):
    B, Hq, Hkv, Tq, Tk, d = 2, 4, 2, 32, 64, 32
    q, k, v = _qkv(rng, B, Hq, Hkv, Tq, Tk, d)
    want = np.asarray(r_ops.multi_head_attention(q, k, v, causal=causal, impl="xla"))
    got = _port(q, k, v, causal=causal, impl="xla")
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, _port(q, k, v, causal=causal, impl="interpret"), **TOL)


def test_impl_switch(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 2, 1, 16, 16, 16))
    before = t_attn.flash_attention.launches
    by_route = dict(t_attn.flash_attention.launches_by_route)
    auto = t_ops.multi_head_attention(q, k, v)              # CPU: xla
    torch.testing.assert_close(
        auto, t_ops.multi_head_attention(q, k, v, impl="xla"), rtol=0, atol=0)
    t_ops.multi_head_attention(q, k, v, impl="pallas")      # CPU: plain
    assert t_attn.flash_attention.launches == before        # no kernel ran
    assert t_attn.flash_attention.launches_by_route == by_route
    # xla_flash: the reference's blockwise path, ported (equal to its own)
    want = r_ops.multi_head_attention(q.numpy(), k.numpy(), v.numpy(),
                                      impl="xla_flash")
    np.testing.assert_allclose(
        t_ops.multi_head_attention(q, k, v, impl="xla_flash").numpy(),
        np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        t_ops.multi_head_attention(q, k, v, impl="flash")


# -- the wgmma route's numerics: p rounded to bfloat16 for PV ---------------

BF16_CASES = [
    # B, Hq, Hkv, Tq, Tk, d, causal, block_q, block_k
    (1, 4, 2, 128, 128, 64, True, 64, 64),
    (1, 2, 1, 256, 256, 128, True, 128, 256),
    (1, 4, 4, 64, 192, 64, False, 64, 64),
    (2, 2, 1, 200, 200, 128, True, 200, 200),    # ragged: 128 divides no T
    (1, 4, 1, 96, 320, 64, True, 32, 64),        # Tq < Tk
    (1, 2, 2, 192, 64, 128, True, 512, 512),     # Tq > Tk, default blocks
    (1, 2, 2, 192, 64, 64, True, 32, 16),        # Tq > Tk, other blocks
]


def _bf16(rng, *shapes):
    """Seeded normals rounded to bfloat16, and the same values as float32."""
    t = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
         for s in shapes]
    return t, [x.float().numpy() for x in t]


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_plain_rounds_p_like_the_reference_xla_path(case, rng):
    """bfloat16 storage at d in (64, 128) takes the wgmma route: its plain
    version rounds p to bfloat16 for the PV product and sums l from the
    float32 p.  Against the reference's kernel on the same values in
    float32 (p kept in float32) an entry may differ by its own bfloat16
    rounding (2^-8 relative: rtol 4e-3) plus one rounding of each p term,
    2^-8 sum_j p_j |v_j| / l, which the plain version returns beside its
    result: about 1e-2 of a typical entry.  The port's xla path rounds
    the normalised p where the plain version rounds the unnormalised one,
    so the two differ by at most one such rounding each (twice the bound)
    and the output rounding of both (rtol 8e-3)."""
    B, Hq, Hkv, Tq, Tk, d, causal, bq, bk = case
    (q, k, v), (qn, kn, vn) = _bf16(
        rng, (B, Hq, Tq, d), (B, Hkv, Tk, d), (B, Hkv, Tk, d))
    assert t_ref.route(q.dtype, d) == "wgmma"
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal, block_q=bq,
              block_k=bk)
    got, p_bound = t_ref.flash_attention_plain(
        q.reshape(B * Hq, Tq, d), k.reshape(B * Hkv, Tk, d),
        v.reshape(B * Hkv, Tk, d), return_p_bound=True, **kw)
    assert got.dtype == torch.bfloat16
    got = got.float().reshape(B, Hq, Tq, d).numpy()
    p_bound = p_bound.reshape(B, Hq, Tq, d).numpy()
    assert (p_bound >= 0).all() and p_bound.max() > 0
    want = np.asarray(r_ops.multi_head_attention(
        qn, kn, vn, causal=causal, impl="interpret", block_q=bq, block_k=bk))
    err = np.abs(got - want)
    assert (err <= 4e-3 * np.abs(want) + p_bound + 1e-6).all(), err.max()
    xla = t_ops.multi_head_attention(q, k, v, causal=causal, impl="xla")
    xla = xla.float().numpy()
    rows = slice(max(Tq - Tk, 0), Tq) if causal else slice(0, Tq)  # rows seeing a key
    err = np.abs(got - xla)[:, :, rows]
    bound = 8e-3 * np.abs(xla) + 2 * p_bound + 1e-6
    assert (err <= bound[:, :, rows]).all(), err.max()


def test_bf16_fully_masked_rows_are_the_exact_mean(rng):
    """Rows that see no key take p = 1 (exact in bfloat16) on every key
    below K_lim, so the wgmma route's plain version gives the mean of V
    over [0, K_lim) as the reference does, with no p rounding at all."""
    B, Hq, Hkv, Tq, Tk, d = 1, 2, 1, 192, 64, 64
    (q, k, v), (qn, kn, vn) = _bf16(
        rng, (B, Hq, Tq, d), (B, Hkv, Tk, d), (B, Hkv, Tk, d))
    got, p_bound = t_ref.flash_attention_plain(
        q.reshape(B * Hq, Tq, d), k.reshape(B * Hkv, Tk, d),
        v.reshape(B * Hkv, Tk, d), n_q_heads=Hq, n_kv_heads=Hkv,
        return_p_bound=True)
    got = got.float().reshape(B, Hq, Tq, d).numpy()
    want = np.asarray(r_ops.multi_head_attention(qn, kn, vn, impl="interpret"))
    masked = Tq - Tk
    np.testing.assert_allclose(got[:, :, :masked], want[:, :, :masked],
                               rtol=4e-3, atol=1e-6)
    mean_v = np.repeat(vn.mean(axis=2), Hq // Hkv, axis=1)[:, :, None]
    np.testing.assert_allclose(
        got[:, :, :masked], np.broadcast_to(mean_v, got[:, :, :masked].shape),
        rtol=4e-3, atol=1e-6)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "fma"), (torch.bfloat16, 16, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
])
def test_route_by_dtype_and_head_dim(dtype, d, want, rng):
    """The kernel is chosen by dtype and head dim, never by a failure; the
    fma route keeps p in float32 (no p bound), the wgmma route rounds it."""
    assert t_ref.route(dtype, d) == want
    assert t_ref.tile_k(dtype, d) == (128 if want == "wgmma" else 64)
    q = torch.from_numpy(rng.normal(size=(2, 32, d)).astype(np.float32)).to(dtype)
    _, p_bound = t_ref.flash_attention_plain(
        q, q[:1], q[:1], n_q_heads=2, n_kv_heads=1, return_p_bound=True)
    assert (p_bound.max() > 0) == (want == "wgmma")
