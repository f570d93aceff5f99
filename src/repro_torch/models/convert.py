"""Params of the reference (``repro.models``) as the port's params.

The reference's ``decoder_init`` returns a nested dict of arrays whose
layout the port keeps: dense weights are ``(d_in, d_out)``, every leaf
under ``blocks`` has a leading ``n_layers`` axis (``jax.vmap`` stacks
them), and a tied head (``tie_embeddings``) has no ``head`` entry.  Its
``xlstm_init`` keeps ``blocks`` a list, one ``{"ln", "core"}`` dict a
layer, whose ``core`` keys differ by the layer's kind.  Its
``hybrid_init`` stacks ``periods/sub{i}`` over a leading ``n_periods``
axis and has no ``head``.  Its ``encdec_init`` (whisper) keeps
``enc_blocks`` and ``dec_blocks`` lists of per-layer dicts and has no
``head`` either.  So the conversion is a copy of every leaf, checked
against the tree, shapes and dtypes the port's init of the same family
(:func:`~.transformer.decoder_init`, :func:`~.transformer.xlstm_init`,
:func:`~.transformer.encdec_init` or :func:`~.hybrid.hybrid_init`) gives
the same config.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..memory.channels import resolve_device
from ..tree import tree_map
from . import hybrid, transformer
from .config import ModelConfig


def _leaf(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _convert(got, want, path: str, device, bad: List[str]):
    if isinstance(want, list):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            have = (f"{len(got)} items" if isinstance(got, (list, tuple))
                    else type(got).__name__)
            bad.append(f"{path or '<root>'}: {have}, want a list of "
                       f"{len(want)}")
            return None
        return [_convert(g, w, f"{path}/{i}", device, bad)
                for i, (g, w) in enumerate(zip(got, want))]
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            keys = sorted(got) if isinstance(got, dict) else type(got).__name__
            bad.append(f"{path or '<root>'}: keys {keys}, want {sorted(want)}")
            return None
        return {k: _convert(got[k], want[k], f"{path}/{k}", device, bad)
                for k in want}
    t = _leaf(got)
    if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
        bad.append(f"{path}: {tuple(t.shape)} {t.dtype}, want "
                   f"{tuple(want.shape)} {want.dtype}")
        return None
    return t.to(device)


def _meta_params(cfg: ModelConfig):
    init = {"ssm_xlstm": transformer.xlstm_init,
            "hybrid_jamba": hybrid.hybrid_init,
            "encdec": transformer.encdec_init}.get(cfg.family,
                                                   transformer.decoder_init)
    return init(cfg, None, device="meta")


def _converted(got, want, what: str, cfg: ModelConfig, device):
    bad: List[str] = []
    out = _convert(got, want, "", device, bad)
    if bad:
        raise ValueError(f"{what} do not match {cfg.arch_id}: "
                         + "; ".join(bad))
    return out


def params_from_jax(cfg: ModelConfig, params: Dict[str, Any], *,
                    device=None) -> Dict[str, Any]:
    """The port's params for ``cfg`` from the reference's nested dict of
    arrays (numpy or anything ``np.asarray`` takes); raises ``ValueError``
    listing every missing key or mismatched shape or dtype."""
    return _converted(params, _meta_params(cfg), "params", cfg,
                      resolve_device(device))


def _scalar_int32(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.shape != () or a.dtype != np.int32:
        raise ValueError(f"a step must be an int32 scalar, got {a.dtype} "
                         f"{a.shape}")
    return torch.tensor(int(a), dtype=torch.int32, device=device)


def train_state_from_jax(cfg: ModelConfig, state: Dict[str, Any], *,
                         device=None) -> Dict[str, Any]:
    """The port's train state (``runtime.train.init_train_state``'s
    layout) from the reference's: its params as :func:`params_from_jax`
    converts them, the AdamW moments ``mu`` and ``nu`` (float32 trees
    shaped like the params), the optimizer's step and the state's step
    (int32 scalars)."""
    dev = resolve_device(device)
    want = _meta_params(cfg)
    moments = tree_map(
        lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta"),
        want)
    opt = state["opt_state"]
    return {
        "params": _converted(state["params"], want, "params", cfg, dev),
        "opt_state": {
            "mu": _converted(opt["mu"], moments, "mu", cfg, dev),
            "nu": _converted(opt["nu"], moments, "nu", cfg, dev),
            "step": _scalar_int32(opt["step"], dev),
        },
        "step": _scalar_int32(state["step"], dev),
    }
