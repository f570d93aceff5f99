"""Every model family's train step held against the reference's on the CPU.

For each arch of ``configs.ARCH_IDS`` at its smoke config: the
reference's state from its own init (``attn_impl="xla"``), moved into the
port with ``train_state_from_jax``; one batch of B 2 x T 16 seeded numpy
tokens and labels (and frames for the encoder-decoder); the loss and the
gradient of every leaf from ``jax.value_and_grad`` against the port's
``value_and_grad``.  This reaches every family's backward: the MoE
dispatch's gathers and ``scatter_add_``, the xLSTM's loops and
``torch.cummax``, the Mamba loop and the cross-attention.

Tolerances: the loss within rtol 1e-5; each gradient leaf within atol 1e-4
of the largest |gradient| in the whole tree (float32 through two layers,
summed in other orders).  The scale is the tree's, not the leaf's: a
leaf whose gradients are all near zero -- the mLSTM's input-gate bias
``core.wi.b``, about 1e-9 against leaves up to 0.26 -- carries float32
noise of the size of its own values, which both packages compute
differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import build_model as r_build_model
from repro.runtime import train as r_train
from repro_torch import configs
from repro_torch.models import build_model, train_state_from_jax
from repro_torch.runtime.train import make_loss_fn, value_and_grad

#: loss rtol; each leaf's atol as a share of the tree's largest |gradient|
LOSS_RTOL, GRAD_ATOL_FRAC = 1e-5, 1e-4


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


def _batch(cfg, rng, B=2, T=16):
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
    }
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def test_every_arch_is_held():
    assert configs.ARCH_IDS == r_configs.ARCH_IDS and len(configs.ARCH_IDS) == 10


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_step_loss_and_grads_match_reference(arch, rng):
    r_cfg = r_configs.get_smoke(arch)
    r_model = r_build_model(r_cfg, attn_impl="xla")
    r_state = r_train.init_train_state(r_model, jax.random.PRNGKey(0))
    batch = _batch(r_cfg, rng)
    r_loss, r_grads = jax.value_and_grad(r_train.make_loss_fn(r_model))(
        r_state["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = configs.get_smoke(arch)
    state = train_state_from_jax(cfg, jax.device_get(r_state), device="cpu")
    loss, grads = value_and_grad(make_loss_fn(build_model(cfg, device="cpu")),
                                 state["params"], batch)
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=LOSS_RTOL)
    want = {n: np.asarray(w, np.float32)
            for n, w in _leaves_by_name(r_grads).items()}
    got = _leaves_by_name(grads)
    assert sorted(got) == sorted(want)
    scale = max(np.abs(w).max() for w in want.values())
    assert scale > 0
    for name, g in got.items():
        assert g.dtype == torch.float32 and tuple(g.shape) == want[name].shape
        np.testing.assert_allclose(g.detach().numpy(), want[name], rtol=0,
                                   atol=GRAD_ATOL_FRAC * scale, err_msg=name)
