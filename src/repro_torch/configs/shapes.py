"""Assigned input shapes and their applicability rules, as the reference's
``repro/configs/shapes.py``.

  train_4k     seq 4,096   global_batch 256   (training)
  prefill_32k  seq 32,768  global_batch 32    (inference prefill)
  decode_32k   seq 32,768  global_batch 128   (decode: 1 new token, KV cache)
  long_500k    seq 524,288 global_batch 1     (long-context decode)

``long_500k`` requires sub-quadratic attention: it runs only for the
SSM/hybrid families (xlstm, jamba); the skip for pure full-attention archs
is surfaced by :func:`applicable`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig

#: an input's (shape, dtype): the port's ``jax.ShapeDtypeStruct``
Spec = Tuple[Tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """Return None if the (arch, shape) cell runs, else the skip reason."""
    spec = SHAPES[shape_name]
    if spec.name == "long_500k" and not cfg.subquadratic:
        return (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.arch_id} is full-attention (see DESIGN.md)"
        )
    return None


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Spec]:
    """``(shape, dtype)`` of every model input of this cell.

    Token ids are ``int32``, as in the reference; the port's models take
    any integer ids (``embed_apply`` indexes with them), and its data
    pipeline hands them ``int32`` too.  For ``[audio]``/``[vlm]`` archs
    the modality frontend is a stub: specs provide precomputed frame
    embeddings (``cfg.compute_dtype``) / fused token ids directly.
    """
    spec = SHAPES[shape_name]
    B, T = spec.global_batch, spec.seq_len
    i32 = torch.int32
    frames = ((B, cfg.n_audio_frames, cfg.d_model),
              getattr(torch, cfg.compute_dtype))
    if spec.kind == "train":
        out = {"tokens": ((B, T), i32), "labels": ((B, T), i32)}
        if cfg.is_encdec:
            out["frames"] = frames
        return out
    if spec.kind == "prefill":
        out = {"tokens": ((B, T), i32)}
        if cfg.is_encdec:
            out["frames"] = frames
        return out
    # decode: one new token against a seq_len cache
    return {"token": ((B,), i32), "cache_index": ((), i32)}

