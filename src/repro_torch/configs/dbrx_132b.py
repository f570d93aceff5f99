"""dbrx-132b [moe]: 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (kv=8) d_ff=10752 vocab=100352, MoE 16e top-4."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    act="swiglu",
    norm="layernorm",
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
)

SMOKE = ModelConfig(
    arch_id="dbrx-132b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=128,
    act="swiglu",
    norm="layernorm",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96),
    param_dtype="float32",
    compute_dtype="float32",
)
