"""The port's training path held against the reference's: the optimizer,
the data, the checkpoints, the train step and loop, and the launcher.

Inputs come from seeded numpy (or the reference's own init, converted
with ``train_state_from_jax``).  Tolerances: the optimizer within rtol
1e-6 (the same float32 arithmetic; the global norm sums in another
order); the train step's loss within 1e-5 relative and every gradient
leaf within 1e-4 max|ref| of ``jax.value_and_grad`` (float32 through two
layers, summed in other orders); after two AdamW steps every leaf's
update within 1e-3 relative L2 of the reference's: in warm-up the steps
are lr g / |g| with lr 1e-5 and 2e-5, and a param near 0.1 is held to a
float32 step of 7e-9, so two updates that differ in the last bit of the
param differ by up to 7e-4 of the update.
Data and checkpoints are bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.data import TokenStream as RTokenStream
from repro.data import cfd_element_stream as r_cfd_stream
from repro.models import build_model as r_build_model
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw as r_adamw
from repro.runtime import train as r_train
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import PrefetchPipeline, TokenStream, cfd_element_stream
from repro_torch.launch import train as t_launch
from repro_torch.models import build_model, train_state_from_jax
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm)
from repro_torch.tree import tree_leaves
from repro_torch.runtime.train import (LoopConfig, TrainLoop,
                                       init_train_state, make_loss_fn,
                                       make_train_step, value_and_grad)

ARCH = "internlm2-1.8b"


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _leaves_by_name(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves_by_name(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves_by_name(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _rel_l2(got, want):
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else np.linalg.norm(got)


# -- optimizer ------------------------------------------------------------------

def _opt_tree(rng):
    # a 2-D weight, a stacked norm scale (L, d) and a 1-D bias
    shapes = {"w": (6, 5), "blocks": {"scale": (3, 8)}, "b": (7,)}
    return {k: (rng.normal(size=v).astype(np.float32) if isinstance(v, tuple)
                else {kk: rng.normal(size=vv).astype(np.float32)
                      for kk, vv in v.items()})
            for k, v in shapes.items()}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def test_adamw_update_matches_reference(rng):
    params = _opt_tree(rng)
    grads = [_map(lambda a: (3 * rng.normal(size=a.shape)).astype(np.float32),
                  params) for _ in range(3)]
    r_cfg = RAdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    t_cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    r_params = _map(jnp.asarray, params)
    r_state = r_adamw.adamw_init(r_params)
    t_params = _map(lambda a: torch.from_numpy(a.copy()), params)
    t_state = adamw_init(t_params)
    for g in grads:   # the global norm clips: about 3 sqrt(79) > 1
        r_params, r_state, r_m = r_adamw.adamw_update(
            r_cfg, _map(jnp.asarray, g), r_state, r_params)
        t_params, t_state, t_m = adamw_update(
            t_cfg, _map(torch.from_numpy, g), t_state, t_params)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(t_m[key]), np.asarray(r_m[key]),
                                       rtol=1e-6)
    assert int(t_state["step"]) == int(r_state["step"]) == 3
    for tree_t, tree_r in ((t_params, r_params), (t_state["mu"], r_state["mu"]),
                           (t_state["nu"], r_state["nu"])):
        want = _leaves_by_name(tree_r)
        for name, got in _leaves_by_name(tree_t).items():
            np.testing.assert_allclose(_np(got), np.asarray(want[name]),
                                       rtol=1e-6, atol=1e-7, err_msg=name)


def _gather_cross_entropy(logits, labels, ignore_id=-1):
    """The loss as it picked its labels by a gather alone, before the
    masked sum (the bits the masked sum must keep)."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    safe = torch.where(labels == ignore_id, 0, labels).long()
    picked = lf.gather(-1, safe[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return -((picked - lse) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_sum_cross_entropy_keeps_the_gathers_bits(rng, dtype):
    """The label pick as a masked sum (``losses.masked_pick``: ``iota ==
    label``, the reference's vocab-parallel form, which DTensor logits
    take) against the gather that plain logits take: the picks and their
    gradients bit for bit, ``ignore_id`` labels among them weighted 0
    (one logit plus zeros; a gradient of one weight plus zeros).  The
    loss (``cross_entropy``) bit for bit the gather loss, and within
    float32 rounding of the reference's ``cross_entropy`` on the same
    numpy inputs (its gradient in float32; a bfloat16 one rounded)."""
    from repro.runtime import losses as r_losses
    from repro_torch.runtime import losses

    x = (4 * rng.normal(size=(3, 17, 301))).astype(np.float32)
    labels = rng.integers(0, 301, size=(3, 17)).astype(np.int32)
    labels[0, :5] = -1
    logits = torch.from_numpy(x).to(getattr(torch, dtype))
    tl = torch.from_numpy(labels)
    weight = torch.from_numpy(rng.normal(size=(3, 17)).astype(np.float32))
    weight = torch.where(tl == -1, 0.0, weight)
    a = logits.clone().requires_grad_(True)
    b = logits.clone().requires_grad_(True)
    safe = torch.where(tl == -1, 0, tl).long()
    pa = a.float().gather(-1, safe[..., None])[..., 0] * weight
    pb = losses.masked_pick(b.float(), tl, torch.arange(301)) * weight
    (ga,) = torch.autograd.grad(pa.sum(), a)
    (gb,) = torch.autograd.grad(pb.sum(), b)
    assert torch.equal(pb, pa) and torch.equal(gb, ga)

    a = logits.clone().requires_grad_(True)
    b = logits.clone().requires_grad_(True)
    want, got = _gather_cross_entropy(a, tl), losses.cross_entropy(b, tl)
    (ga,) = torch.autograd.grad(want, a)
    (gb,) = torch.autograd.grad(got, b)
    assert torch.equal(got, want) and torch.equal(gb, ga)
    r_logits = jnp.asarray(logits.float().numpy())
    ref = r_losses.cross_entropy(r_logits, jnp.asarray(labels))
    r_grad = jax.grad(lambda z: r_losses.cross_entropy(z, jnp.asarray(
        labels)))(r_logits)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6)
    # a bfloat16 gradient is the float32 one rounded: 2^-8 relative
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(_np(gb.float()), np.asarray(r_grad),
                               rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("step", [0, 1, 2, 5, 10, 55, 100, 150])
def test_cosine_schedule_matches_reference(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100)
    got = cosine_schedule(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = r_adamw.cosine_schedule(RAdamWConfig(**kw), jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_global_norm_matches_reference(rng):
    tree = _opt_tree(rng)
    np.testing.assert_allclose(
        _np(global_norm(_map(torch.from_numpy, tree))),
        np.asarray(r_adamw.global_norm(_map(jnp.asarray, tree))), rtol=1e-6)


def test_adamw_minimizes_quadratic_and_reports_unclipped_norm():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, grad_clip=100.0)
    state = adamw_init(params)
    for _ in range(150):
        params, state, _ = adamw_update(opt, {"w": 2 * params["w"]}, state,
                                        params)
    assert params["w"].abs().max().item() < 0.05
    _, _, m = adamw_update(AdamWConfig(), {"w": torch.full((2,), 1e6)},
                           adamw_init(params), params)
    assert m["grad_norm"].item() > 1e6


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "whisper-tiny"])
def test_token_stream_is_bitwise_the_reference(arch):
    cfg, r_cfg = configs.get_smoke(arch), r_configs.get_smoke(arch)
    got = TokenStream(vocab=cfg.vocab, batch=2, seq_len=16, seed=3,
                      start_step=1, cfg=cfg)
    want = RTokenStream(vocab=cfg.vocab, batch=2, seq_len=16, seed=3,
                        start_step=1, cfg=r_cfg)
    for _ in range(3):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert got.state() == want.state()
    a, b = next(cfd_element_stream(4, 8, seed=2)), next(r_cfd_stream(4, 8, seed=2))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_pipeline_keeps_order_on_cpu():
    src = TokenStream(vocab=64, batch=2, seq_len=8, seed=5)
    ref = TokenStream(vocab=64, batch=2, seq_len=8, seed=5)
    pf = PrefetchPipeline(src, device="cpu")
    for _ in range(4):
        a, b = next(pf), next(ref)
        assert isinstance(a["tokens"], torch.Tensor)
        assert a["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"])
        np.testing.assert_array_equal(a["labels"].numpy(), b["labels"])
    assert pf.state() == {"step": src.step, "seed": 5}
    pf.close()


def test_prefetch_pipeline_surfaces_source_errors():
    def source():
        yield {"x": np.zeros(2)}
        raise RuntimeError("source failed")

    pf = PrefetchPipeline(source(), device="cpu")
    next(pf)
    with pytest.raises(RuntimeError, match="source failed"):
        next(pf)


# -- checkpoints ----------------------------------------------------------------

def _meta_like(tree):
    return _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                tree)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(5), "nested": {"b": torch.ones(2, 3),
                                              "c": torch.randn(4).bfloat16()}}
    for s in (1, 2, 3):
        mgr.save(state, step=s)
    assert mgr.latest_step() == 3
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(dirs) == 2  # gc kept 2
    restored = mgr.restore(_meta_like(state))
    for k, want in (("a", state["a"]), ("b", state["nested"]["b"]),
                    ("c", state["nested"]["c"])):
        got = restored[k] if k == "a" else restored["nested"][k]
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.zeros(4)
    mgr.save({"x": x}, step=7, blocking=False)
    x += 1   # the host copy was taken before save returned
    mgr.wait()
    assert mgr.latest_step() == 7
    assert torch.equal(mgr.restore({"x": x})["x"], torch.zeros(4))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": torch.zeros(4)}, step=1)
    with pytest.raises(ValueError):
        mgr.restore({"x": torch.empty(5, device="meta")})
    with pytest.raises(KeyError):
        mgr.restore({"y": torch.empty(4, device="meta")})


def test_checkpoint_layout_is_the_reference_and_restores_its_bf16(tmp_path, rng):
    w = rng.normal(size=(3, 4)).astype(np.float32)
    r_state = {"params": {"w": jnp.asarray(w, jnp.bfloat16),
                          "blocks": [jnp.ones(2), jnp.zeros((2, 2))]},
               "step": jnp.int32(9)}
    RCheckpointManager(str(tmp_path / "ref")).save(r_state, step=9)
    t_state = {"params": {"w": torch.from_numpy(w).bfloat16(),
                          "blocks": [torch.ones(2), torch.zeros(2, 2)]},
               "step": torch.tensor(9, dtype=torch.int32)}
    CheckpointManager(str(tmp_path / "port")).save(t_state, step=9)
    manifests = [json.load(open(tmp_path / d / "step_00000009" / "manifest.json"))
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert {l["name"]: l["dtype"] for l in manifests[0]["leaves"]}[
        "params.w"] == "bfloat16"
    restored = CheckpointManager(str(tmp_path / "ref")).restore(
        _meta_like(t_state))
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["w"], t_state["params"]["w"])
    assert torch.equal(restored["params"]["blocks"][1], torch.zeros(2, 2))
    assert int(restored["step"]) == 9


# -- the train step ------------------------------------------------------------

def _batch(cfg, rng, B=2, T=16):
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
    }
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def reference_state():
    r_cfg = r_configs.get_smoke(ARCH)
    r_model = r_build_model(r_cfg, attn_impl="xla")
    return r_cfg, r_model, r_train.init_train_state(r_model,
                                                    jax.random.PRNGKey(0))


def test_train_step_loss_and_grads_match_reference(reference_state, rng):
    r_cfg, r_model, r_state = reference_state
    batch = _batch(r_cfg, rng)
    r_loss, r_grads = jax.value_and_grad(r_train.make_loss_fn(r_model))(
        r_state["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = configs.get_smoke(ARCH)
    state = train_state_from_jax(cfg, jax.device_get(r_state), device="cpu")
    loss, grads = value_and_grad(make_loss_fn(build_model(cfg, device="cpu")),
                                 state["params"], batch)
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-5)
    want = _leaves_by_name(r_grads)
    got = _leaves_by_name(grads)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_two_steps_from_the_reference_state_match_reference(reference_state, rng):
    r_cfg, r_model, r_state0 = reference_state
    batches = [_batch(r_cfg, rng) for _ in range(2)]
    r_step = jax.jit(r_train.make_train_step(r_model, RAdamWConfig(lr=1e-3)))
    r_state = r_state0
    r_metrics = []
    for b in batches:
        r_state, m = r_step(r_state, {k: jnp.asarray(v) for k, v in b.items()})
        r_metrics.append(m)
    cfg = configs.get_smoke(ARCH)
    state = train_state_from_jax(cfg, jax.device_get(r_state0), device="cpu")
    p0 = {k: v.clone() for k, v in _leaves_by_name(state["params"]).items()}
    step = make_train_step(build_model(cfg, device="cpu"), AdamWConfig(lr=1e-3))
    for b, rm in zip(batches, r_metrics):
        state, m = step(state, b)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key].item(), float(rm[key]),
                                       rtol=1e-5, err_msg=key)
    assert int(state["step"]) == int(state["opt_state"]["step"]) == 2
    want = _leaves_by_name(jax.device_get(r_state["params"]))
    for name, p in _leaves_by_name(state["params"]).items():
        base = _np(p0[name])
        assert _rel_l2(_np(p) - base, np.asarray(want[name]) - base) < 1e-3, name


def test_grad_accum_two_matches_one(rng):
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    batch = _batch(cfg, rng, B=4)
    out = {}
    for accum in (1, 2):
        state = init_train_state(model, torch.Generator().manual_seed(0))
        step = make_train_step(model, AdamWConfig(lr=1e-3), grad_accum=accum)
        state, m = step(state, batch)
        out[accum] = (m, state["params"])
    # the mean of two microbatch losses is the whole batch's mean (equal
    # token counts): float32 sums in another order
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(out[2][0][key].item(),
                                   out[1][0][key].item(), rtol=1e-5)
    for a, b in zip(tree_leaves(out[2][1]), tree_leaves(out[1][1])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_smoke_train_step(arch, rng):
    cfg = configs.get_smoke(arch)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    state, metrics = step(state, _batch(cfg, rng))
    assert np.isfinite(metrics["loss"].item())
    assert np.isfinite(metrics["grad_norm"].item())
    assert int(state["step"]) == 1
    assert all(torch.isfinite(p).all() for p in tree_leaves(state["params"]))


# -- loop + fault tolerance -----------------------------------------------------

def _tiny():
    cfg = configs.get_smoke(ARCH)
    return cfg, build_model(cfg, device="cpu")


def test_trainloop_checkpoint_resume(tmp_path):
    cfg, model = _tiny()
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    mgr = CheckpointManager(str(tmp_path))
    state = init_train_state(model, torch.Generator().manual_seed(0))
    data = TokenStream(vocab=cfg.vocab, batch=2, seq_len=16, cfg=cfg)
    loop = TrainLoop(step, state, iter(data),
                     cfg=LoopConfig(total_steps=6, checkpoint_every=2),
                     checkpointer=mgr)
    final = loop.run()
    assert mgr.latest_step() == 6
    whole = {k: v.clone() for k, v in _leaves_by_name(final).items()}
    # resume from step 4: the same data, the same state, bit for bit
    restored = mgr.restore(final, step=4)
    assert int(restored["step"]) == 4
    data2 = TokenStream(vocab=cfg.vocab, batch=2, seq_len=16, cfg=cfg,
                        start_step=4)
    loop2 = TrainLoop(step, restored, iter(data2),
                      cfg=LoopConfig(total_steps=6, checkpoint_every=10))
    resumed = loop2.run()
    assert [h["step"] for h in loop2.history] == [4, 5]
    assert [h["loss"] for h in loop2.history] == [
        h["loss"] for h in loop.history[4:]]
    for name, v in _leaves_by_name(resumed).items():
        assert torch.equal(v, whole[name]), name


def test_trainloop_retry_then_checkpoint_on_failure(tmp_path):
    cfg, model = _tiny()
    real_step = make_train_step(model, AdamWConfig(lr=1e-3))
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 2:  # transient fault once
            raise RuntimeError("simulated device failure")
        return real_step(state, batch)

    data = TokenStream(vocab=cfg.vocab, batch=2, seq_len=16, cfg=cfg)
    mgr = CheckpointManager(str(tmp_path))
    loop = TrainLoop(flaky_step, init_train_state(
        model, torch.Generator().manual_seed(0)), iter(data),
        cfg=LoopConfig(total_steps=3, max_retries=1), checkpointer=mgr)
    loop.run()
    assert len(loop.history) == 3  # recovered via retry

    def broken_step(state, batch):
        raise RuntimeError("persistent failure")

    loop = TrainLoop(broken_step, loop.state, iter(data),
                     cfg=LoopConfig(total_steps=5, max_retries=1),
                     checkpointer=mgr)
    with pytest.raises(RuntimeError, match="persistent"):
        loop.run()
    assert mgr.latest_step() == 3  # progress persisted before propagating


# -- the launcher ----------------------------------------------------------------

def test_entry_points_default_to_the_card():
    """The prefetch and the launcher take the CUDA card unless given
    ``device="cpu"``, and raise without one rather than fall back."""
    src = TokenStream(vocab=8, batch=1, seq_len=4)
    if torch.cuda.is_available():
        pf = PrefetchPipeline(src)
        assert pf.device.type == "cuda"
        pf.close()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchPipeline(src)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--smoke", "--steps", "1"])


def test_launch_train_cli_on_cpu(tmp_path, capsys):
    # the launcher checkpoints every 25 steps
    args = ["--smoke", "--steps", "25", "--batch", "2", "--seq-len", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    assert t_launch.main(args) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "steps 0..24: loss" in out
    assert t_launch.main(args + ["--resume", "--steps", "27"]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 25" in out and "steps 25..26: loss" in out
    # one process is a world of one: a model axis of 2 does not divide it
    with pytest.raises(ValueError, match="nproc-per-node"):
        t_launch.main(args + ["--model-axis", "2"])
