"""olmoe-1b-7b [moe]: 64 experts top-8.  [arXiv:2409.02060; hf]
16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304, MoE 64e top-8."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
)

SMOKE = ModelConfig(
    arch_id="olmoe-1b-7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=128,
    act="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
    param_dtype="float32",
    compute_dtype="float32",
)
