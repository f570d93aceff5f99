"""The flash kernels' launches as PyTorch ops (``repro_torch::flash_fwd``,
``repro_torch::flash_bwd``) on ``meta`` tensors, on the CPU.

* Their fakes give the shapes and dtypes of the plain versions' outputs,
  forward (with and without the LSE) and backward, on both routes'
  shapes: bfloat16 at head dims 64 and 128 (wgmma), float32 and bfloat16
  at 16 (fma); GQA, causal and not, ``Tq <= Tk`` (and ``Tq > Tk``
  forward); they refuse what the kernels refuse.
* ``launch.dryrun.FLOP_FORMULAS`` counts their work: 4 d flops a visible
  pair forward, 10 d backward, pairs by the reference's visit rule,
  equal to a count of the pairs whose ``p`` is nonzero, row by row.
* A ``meta`` train step through ``attn_impl="auto"`` builds in the dry
  run (rank 0 of a one-rank fake group, in a subprocess): its products
  are the ``xla`` step's but attention's, and its flash ops count the
  formula of every layer, the remat recompute's forward included.

The card's side (the ops launch the same kernels bitwise) is
``tests/test_torch_cuda.py::test_flash_custom_ops_launch_the_kernels_directly``.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.kernels.attention import attention as t_attn
from repro_torch.kernels.attention import ref as t_ref
from repro_torch.launch import dryrun

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: (B, Hq, Hkv, Tq, Tk, d, dtype, causal)
CASES = [(2, 4, 2, 64, 64, 64, torch.bfloat16, True),
         (1, 8, 1, 32, 96, 128, torch.bfloat16, True),
         (2, 4, 4, 48, 80, 64, torch.bfloat16, False),
         (2, 4, 2, 64, 64, 16, torch.float32, True),
         (1, 2, 1, 16, 48, 16, torch.bfloat16, True)]


def _inputs(case, device):
    B, Hq, Hkv, Tq, Tk, d, dtype, _ = case
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=gen).to(dtype).to(device)
                   for s in ((B * Hq, Tq, d), (B * Hkv, Tk, d),
                             (B * Hkv, Tk, d), (B * Hq, Tq, d)))
    return q, k, v, do


def _meta(ts):
    return [(t.shape, t.dtype) for t in ts]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("case", CASES + [
    (1, 2, 1, 96, 32, 64, torch.bfloat16, True)], ids=str)
def test_forward_fake_gives_the_plain_versions_shapes(case, with_lse):
    q, k, v, _ = _inputs(case, "cpu")
    Hq, Hkv, causal = case[1], case[2], case[7]
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal, scale=0.125)
    want = t_ref.flash_attention_plain(q, k, v, block_q=16, block_k=16,
                                       return_lse=with_lse, **kw)
    want = want if with_lse else (want,)
    o, lse = torch.ops.repro_torch.flash_fwd(
        *(t.to("meta") for t in (q, k, v)), Hq, Hkv, causal, 0.125, 16, 16,
        with_lse)
    assert o.device.type == lse.device.type == "meta"
    assert _meta((o, lse) if with_lse else (o,)) == _meta(want)
    if not with_lse:
        assert lse.numel() == 0


@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_fake_gives_the_plain_versions_shapes(case):
    q, k, v, do = _inputs(case, "cpu")
    Hq, Hkv, causal = case[1], case[2], case[7]
    kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal, scale=0.125)
    o, lse = t_ref.flash_attention_plain(q, k, v, return_lse=True, **kw)
    want = t_ref.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    got = torch.ops.repro_torch.flash_bwd(
        *(t.to("meta") for t in (q, k, v, o, lse, do)), Hq, Hkv, causal,
        0.125)
    assert all(g.device.type == "meta" for g in got)
    assert _meta(got) == _meta(want)


def test_fakes_refuse_what_the_kernels_refuse():
    q = torch.empty(4, 48, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 32, 64, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(4, 48, device="meta")
    with pytest.raises(ValueError, match="not divisible by blocks"):
        torch.ops.repro_torch.flash_fwd(q, k, k, 2, 1, True, 0.125, 32, 32,
                                        False)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        torch.ops.repro_torch.flash_bwd(q, k, k, q, lse, q, 2, 1, True, 0.125)
    with pytest.raises(ValueError, match="do not fold"):
        torch.ops.repro_torch.flash_fwd(q, k, k, 3, 1, True, 0.125, 48, 32,
                                        False)


def _pairs_by_rows(Tq, Tk, bq, bk, causal):
    """The pairs whose p is nonzero, row by row from the key limits."""
    lim = t_ref.key_limits(Tq, Tk, bq, bk, causal).tolist()
    n = 0
    for t in range(Tq):
        seen = min(max(Tk - Tq + t + 1, 0), Tk) if causal else Tk
        n += seen if seen > 0 else lim[t]
    return n


@pytest.mark.parametrize("shape", [(64, 64, 16, 16, True),
                                   (48, 80, 16, 16, True),
                                   (96, 32, 32, 16, True),
                                   (96, 32, 64, 32, True),
                                   (40, 72, 8, 8, False)])
def test_visible_pairs_follow_the_visit_rule(shape):
    assert t_ref.visible_pairs(*shape) == _pairs_by_rows(*shape) > 0


def test_meta_attention_flops_equal_the_formula():
    """One attention's forward and backward through ``impl="auto"`` on
    ``meta`` (the kernels' ops): ``dryrun.Meter`` counts (4 + 10) d
    flops a visible pair of each query head, nothing launched."""
    from repro_torch.kernels.attention import ops

    B, Hq, Hkv, T, d = 2, 4, 2, 32, 64
    q, k, v = (torch.empty(B, h, T, d, dtype=torch.bfloat16, device="meta",
                           requires_grad=True) for h in (Hq, Hkv, Hkv))
    n = t_attn.flash_attention.launches, t_attn.flash_attention_bwd.launches
    meter = dryrun.Meter()
    with meter:
        o = ops.multi_head_attention(q, k, v, impl="auto")
        torch.autograd.grad(o.sum(), (q, k, v))
    pairs = T * (T + 1) // 2
    assert meter.flops == (4 + 10) * d * B * Hq * pairs
    assert (t_attn.flash_attention.launches,
            t_attn.flash_attention_bwd.launches) == n


STEP = textwrap.dedent("""
    import collections, dataclasses, json
    from repro_torch import configs
    from repro_torch.configs import shapes as ts
    from repro_torch.launch import dryrun, mesh as mesh_mod
    ts.SHAPES["check"] = ts.ShapeSpec("check", "train", 32, 2)
    m = dryrun.fake_mesh(mesh_mod.MeshShape(("data", "model"), (1, 1)))
    dryrun.set_dispatch(m, False)
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                              compute_dtype="bfloat16",
                              param_dtype="bfloat16", n_heads=4,
                              n_kv_heads=2, d_model=256)
    count = dryrun._flops
    out = {}
    for impl in ("xla", "auto"):
        by = collections.Counter()
        def counted(func, args, kwargs, o):
            n = count(func, args, kwargs, o)
            by[func._overloadpacket.__name__] += n
            return n
        dryrun._flops = counted
        c = dryrun.count_cell(cfg, "check", m, attn_impl=impl)
        out[impl] = {"flops": c["flops"], "by": by,
                     "temp": c["memory"]["temp_size_in_bytes"]}
    dryrun.release_fake_group()
    out["cfg"] = [cfg.n_layers, cfg.n_heads, cfg.d_model // cfg.n_heads,
                  cfg.remat]
    print(json.dumps(out))
""")


def test_meta_train_step_through_auto_counts_the_formula():
    """Phase T's step at smoke widths (bfloat16, head dim 64: the wgmma
    route's shapes), 2 x 32 tokens, remat "block": the products of the
    ``auto`` step are the ``xla`` step's matrix products but attention's
    (its ``bmm``), and its flash ops count, a layer, the forward twice
    (the recompute) and the backward once by the formula."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", STEP], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    layers, heads, d, remat = out["cfg"]
    assert remat == "block"
    B, T = 2, 32
    pairs = T * (T + 1) // 2
    by = out["auto"]["by"]
    assert by["flash_fwd"] == layers * 2 * 4 * d * B * heads * pairs
    assert by["flash_bwd"] == layers * 10 * d * B * heads * pairs
    assert by.get("bmm", 0) == 0 < out["xla"]["by"]["bmm"]
    assert by["mm"] == out["xla"]["by"]["mm"] > 0
    assert out["auto"]["flops"] == by["mm"] + by["flash_fwd"] + by["flash_bwd"]
