"""Unified model facade: ``build_model(cfg)`` -> :class:`Model` with init /
forward / prefill / decode, dispatching on the architecture family.

Every family of the reference is ported: the decoders ``dense``, ``moe``
and ``vlm``, the jamba hybrid ``hybrid_jamba``, the recurrent
``ssm_xlstm`` and the encoder-decoder ``encdec`` (whisper).  The model
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
    if fam not in ("dense", "moe", "vlm", "hybrid_jamba", "ssm_xlstm",
                   "encdec"):
        raise ValueError(f"unknown family {fam!r}")
    dev = resolve_device(device)

    def tokens_of(batch):
        return torch.as_tensor(batch["tokens"], device=dev)

    if fam == "ssm_xlstm":
        return _xlstm_model(cfg, dev, tokens_of)
    if fam == "encdec":
        return _encdec_model(cfg, dev, tokens_of, attn_impl)
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


def _encdec_model(cfg: ModelConfig, dev: torch.device, tokens_of,
                  attn_impl: str) -> Model:
    """The encoder-decoder: a batch holds ``frames`` (B, n_audio_frames,
    d_model) and ``tokens``.  Prefill encodes at the default
    ``attn_impl="auto"`` whatever the model's, as the reference's does
    (the flash kernel on the card, a launch an encoder layer); decode
    takes a scalar ``cache_index``.  ``moe_capacity`` is accepted and
    ignored, as by the reference."""
    def frames_of(batch):
        return torch.as_tensor(batch["frames"], device=dev)

    def fwd(params, batch, moe_capacity=None):
        return transformer.encdec_forward(
            params, frames_of(batch), tokens_of(batch), cfg,
            attn_impl=attn_impl)

    def prefill(params, batch, cache, moe_capacity=None):
        return transformer.encdec_prefill(
            params, frames_of(batch), tokens_of(batch), cache, cfg)

    def decode(params, token, cache, cache_index, moe_capacity=None):
        return transformer.encdec_decode_step(
            params, torch.as_tensor(token, device=dev), cache, cache_index,
            cfg)

    return Model(
        cfg=cfg,
        device=dev,
        init=lambda generator: transformer.encdec_init(
            cfg, generator, device=dev),
        forward=fwd,
        init_cache=lambda batch, max_len: transformer.encdec_init_cache(
            cfg, batch, max_len, device=dev),
        prefill=prefill,
        decode_step=decode,
    )
