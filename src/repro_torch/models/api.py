"""Unified model facade: ``build_model(cfg)`` -> :class:`Model` with init /
forward / prefill / decode, dispatching on the architecture family.

The decoder families ``dense``, ``moe`` and ``vlm``, the jamba hybrid
``hybrid_jamba`` and the recurrent ``ssm_xlstm`` are ported.  The model
runs on ``device`` (default: the CUDA card; ``device="cpu"`` for the
plain paths); ``init`` draws params from an explicit ``torch.Generator``
on that device, and inputs are moved to it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..memory.channels import resolve_device
from . import hybrid, transformer
from .config import ModelConfig

Params = Dict[str, Any]

#: families of the reference not ported yet, and their ROADMAP item
NOT_PORTED = {
    "encdec": "ROADMAP queue 1, item 12 (encoder-decoder)",
}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    #: init(generator) -> params on ``device``
    init: Callable[[torch.Generator], Params]
    #: forward(params, batch) -> float32 logits; batch is a dict of tensors
    forward: Callable[..., torch.Tensor]
    init_cache: Optional[Callable[..., Any]] = None
    prefill: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    decode_step: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None

    @property
    def arch_id(self) -> str:
        return self.cfg.arch_id


def build_model(cfg: ModelConfig, *, attn_impl: str = "auto",
                device=None) -> Model:
    """The model of ``cfg``'s family.  ``attn_impl`` picks the cache-less
    attention (``"auto"``: the flash kernel on the card, plain ops on the
    CPU; see ``kernels.attention.ops``)."""
    fam = cfg.family
    if fam in NOT_PORTED:
        raise NotImplementedError(
            f"model family {fam!r} is not ported yet: {NOT_PORTED[fam]}"
        )
    if fam not in ("dense", "moe", "vlm", "hybrid_jamba", "ssm_xlstm"):
        raise ValueError(f"unknown family {fam!r}")
    dev = resolve_device(device)

    def tokens_of(batch):
        return torch.as_tensor(batch["tokens"], device=dev)

    if fam == "ssm_xlstm":
        return _xlstm_model(cfg, dev, tokens_of)
    # the decoders and the jamba hybrid take the same calls; the hybrid's
    # cache holds Mamba states beside k and v (new each call), and its
    # decode takes a scalar cache_index
    if fam == "hybrid_jamba":
        fns = (hybrid.hybrid_init, hybrid.hybrid_forward,
               hybrid.hybrid_init_cache, hybrid.hybrid_prefill,
               hybrid.hybrid_decode_step)
    else:
        fns = (transformer.decoder_init, transformer.decoder_forward,
               transformer.decoder_init_cache, transformer.decoder_prefill,
               transformer.decoder_decode_step)
    init, forward, init_cache, prefill_fn, decode_fn = fns

    # moe_capacity: the global slots per expert of every MoE block in the
    # call (default: from the call's token count); dense blocks ignore it
    def fwd(params, batch, moe_capacity=None):
        return forward(params, tokens_of(batch), cfg, attn_impl=attn_impl,
                       moe_capacity=moe_capacity)

    def prefill(params, batch, cache, moe_capacity=None):
        return prefill_fn(params, tokens_of(batch), cache, cfg,
                          moe_capacity=moe_capacity)

    def decode(params, token, cache, cache_index, moe_capacity=None):
        if isinstance(cache_index, torch.Tensor):
            cache_index = cache_index.to(dev)
        return decode_fn(params, torch.as_tensor(token, device=dev), cache,
                         cache_index, cfg, moe_capacity=moe_capacity)

    return Model(
        cfg=cfg,
        device=dev,
        init=lambda generator: init(cfg, generator, device=dev),
        forward=fwd,
        init_cache=lambda batch, max_len: init_cache(cfg, batch, max_len,
                                                     device=dev),
        prefill=prefill,
        decode_step=decode,
    )


def _xlstm_model(cfg: ModelConfig, dev: torch.device, tokens_of) -> Model:
    """The xLSTM: its cache is the list of per-layer recurrent states
    (``max_len`` is ignored), prefill and decode return the last
    position's logits and new states, and decode ignores ``cache_index``
    (the state knows its position).  ``moe_capacity`` is accepted and
    ignored, as by the reference."""
    def fwd(params, batch, moe_capacity=None):
        return transformer.xlstm_forward(params, tokens_of(batch), cfg)

    def prefill(params, batch, cache, moe_capacity=None):
        logits, states = transformer.xlstm_forward(
            params, tokens_of(batch), cfg, states=cache)
        return logits[:, -1], states

    def decode(params, token, cache, cache_index, moe_capacity=None):
        token = torch.as_tensor(token, device=dev)
        logits, states = transformer.xlstm_forward(
            params, token[:, None], cfg, states=cache)
        return logits[:, -1], states

    return Model(
        cfg=cfg,
        device=dev,
        init=lambda generator: transformer.xlstm_init(
            cfg, generator, device=dev),
        forward=fwd,
        init_cache=lambda batch, max_len: transformer.xlstm_init_states(
            cfg, batch, device=dev),
        prefill=prefill,
        decode_step=decode,
    )
