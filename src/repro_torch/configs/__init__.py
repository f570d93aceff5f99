"""Architecture registry: the 10 assigned architectures (+ the paper's
own CFD operator configs live in repro_torch.cfd).

Use ``get(arch_id)`` for the full config and ``get_smoke(arch_id)`` for
the reduced same-family smoke config.  The config files are copies of
the reference's, and ``shapes`` holds the assigned input shapes.
"""
from __future__ import annotations

from typing import Dict, List

from ..models.config import ModelConfig
from . import (
    chameleon_34b,
    command_r_plus_104b,
    dbrx_132b,
    internlm2_1_8b,
    jamba_1_5_large_398b,
    olmoe_1b_7b,
    qwen2_7b,
    qwen3_14b,
    shapes,
    whisper_tiny,
    xlstm_125m,
)

_MODULES = {
    "whisper-tiny": whisper_tiny,
    "command-r-plus-104b": command_r_plus_104b,
    "internlm2-1.8b": internlm2_1_8b,
    "qwen3-14b": qwen3_14b,
    "qwen2-7b": qwen2_7b,
    "dbrx-132b": dbrx_132b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "xlstm-125m": xlstm_125m,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "chameleon-34b": chameleon_34b,
}

ARCH_IDS: List[str] = list(_MODULES)


def get(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}
