"""qwen2-7b [dense]: GQA, QKV bias.  [arXiv:2407.10671; hf]
28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    arch_id="qwen2-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=128,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    param_dtype="float32",
    compute_dtype="float32",
)
