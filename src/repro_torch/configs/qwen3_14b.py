"""qwen3-14b [dense]: qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]
40L d_model=5120 40H (kv=8) d_ff=17408 vocab=151936."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    arch_id="qwen3-14b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=128,
    head_dim=16,
    qk_norm=True,
    act="swiglu",
    norm="rmsnorm",
    param_dtype="float32",
    compute_dtype="float32",
)
