"""internlm2-1.8b [dense]: GQA.  [arXiv:2403.17297; hf]
24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92544."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    arch_id="internlm2-1.8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=128,
    act="swiglu",
    norm="rmsnorm",
    param_dtype="float32",
    compute_dtype="float32",
)
