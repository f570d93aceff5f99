"""Model configuration shared by every assigned architecture."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    #: which decoder layers carry a MoE FFN ("all", "odd", "none")
    layout: str = "all"


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    #: place an sLSTM block every N layers (others are mLSTM)
    slstm_every: int = 4
    proj_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm_xlstm | hybrid_jamba | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_bias: bool = False
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    #: hybrid (jamba): attention once per this many layers (else mamba)
    attn_period: int = 0

    #: encoder-decoder (whisper): encoder depth + frame count (stub frontend)
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500

    #: dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    #: remat policy for scan-over-layers: "none" | "block"
    remat: str = "block"

    #: sub-quadratic attention available (drives long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm_xlstm", "hybrid_jamba")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * Hq + 2 * d * hd * Hkv + hd * Hq * d
        dense_mlp = 3 * d * ff if self.act == "swiglu" else 2 * d * ff
        total = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn + dense_mlp)
        elif self.family == "moe":
            m = self.moe
            expert = (3 if self.act == "swiglu" else 2) * d * m.d_ff_expert
            total += self.n_layers * (attn + m.n_experts * expert + d * m.n_experts)
        elif self.family == "hybrid_jamba":
            m = self.mamba
            d_in = m.expand * d
            dtr = m.dt_rank or -(-d // 16)
            mamba_p = (
                d * 2 * d_in + d_in * m.d_conv
                + d_in * (dtr + 2 * m.d_state) + dtr * d_in
                + d_in * m.d_state + d_in + d_in * d
            )
            n_attn = self.n_layers // self.attn_period
            n_mamba = self.n_layers - n_attn
            mo = self.moe
            expert = (3 if self.act == "swiglu" else 2) * d * mo.d_ff_expert
            n_moe = self.n_layers // 2
            n_dense = self.n_layers - n_moe
            total += (
                n_attn * attn + n_mamba * mamba_p
                + n_moe * (mo.n_experts * expert + d * mo.n_experts)
                + n_dense * dense_mlp
            )
        elif self.family == "ssm_xlstm":
            # rough: mLSTM qkv + gates + out
            x = self.xlstm
            d_in = int(x.proj_factor * d)
            per = d * d_in * 2 + d_in * d + 3 * d_in * hd * Hq // max(Hq, 1)
            total += self.n_layers * (per + dense_mlp if ff else per)
        elif self.family == "encdec":
            total += (self.n_layers + self.n_encoder_layers) * (
                attn + dense_mlp
            ) + self.n_layers * attn  # cross attention
        return total
