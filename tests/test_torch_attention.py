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


def test_no_visited_tile_gives_zero(rng):
    """A query tile wholly above the diagonal visits no key tile:
    l == 0 is divided as 1, so its rows are 0.  The reference kernel
    gives the same when its blocks are the port's 64 x 64 tiles."""
    B, Hq, Hkv, Tq, Tk, d = 1, 2, 1, 192, 64, 16  # tiles 0, 1 end above
    q, k, v = _qkv(rng, B, Hq, Hkv, Tq, Tk, d)
    got = _port(q, k, v, impl="interpret")
    assert (got[:, :, :128] == 0).all()
    assert np.isfinite(got).all()
    want = np.asarray(r_ops.multi_head_attention(
        q, k, v, impl="interpret", block_q=64, block_k=64))
    np.testing.assert_allclose(got, want, **TOL)


def test_fully_masked_rows_differ_from_the_reference_at_its_default_blocks(rng):
    """Where the reference's blocks are not the port's tiles, rows that
    see no key can differ.  Tq = 128, Tk = 64, default blocks: the
    reference's one query block (last row at position 63) visits key
    block 0, so rows 0..63 are the mean of V; the port's tile 0 (last row
    at position -1) visits nothing, so they are 0.  Rows 64..127 see
    keys and agree."""
    B, Hq, Hkv, Tq, Tk, d = 1, 2, 1, 128, 64, 16
    q, k, v = _qkv(rng, B, Hq, Hkv, Tq, Tk, d)
    want = np.asarray(r_ops.multi_head_attention(q, k, v, impl="interpret"))
    mean_v = np.repeat(v.mean(axis=2), Hq // Hkv, axis=1)[:, :, None]
    np.testing.assert_allclose(want[:, :, :64], np.broadcast_to(
        mean_v, want[:, :, :64].shape), **TOL)
    for impl in ("interpret", "pallas"):
        got = _port(q, k, v, impl=impl)
        assert (got[:, :, :64] == 0).all()
        np.testing.assert_allclose(got[:, :, 64:], want[:, :, 64:], **TOL)


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
    auto = t_ops.multi_head_attention(q, k, v)              # CPU: xla
    torch.testing.assert_close(
        auto, t_ops.multi_head_attention(q, k, v, impl="xla"), rtol=0, atol=0)
    t_ops.multi_head_attention(q, k, v, impl="pallas")      # CPU: plain
    assert t_attn.flash_attention.launches == before        # no kernel ran
    with pytest.raises(NotImplementedError, match="training"):
        t_ops.multi_head_attention(q, k, v, impl="xla_flash")
    with pytest.raises(ValueError, match="unknown attention impl"):
        t_ops.multi_head_attention(q, k, v, impl="flash")
