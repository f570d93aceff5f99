"""chameleon-34b [vlm]: early-fusion, VQ image tokens (stubbed -- specs
deliver fused token ids).  [arXiv:2405.09818; unverified]
48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,            # chameleon's qk-norm stabilization
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    arch_id="chameleon-34b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=128,
    qk_norm=True,
    act="swiglu",
    norm="rmsnorm",
    param_dtype="float32",
    compute_dtype="float32",
)
