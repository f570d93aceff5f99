"""command-r-plus-104b [dense]: GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
64L d_model=12288 96H (kv=8) d_ff=33792 vocab=256000."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    act="swiglu",
    norm="layernorm",
    rope_theta=75_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="command-r-plus-104b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=128,
    act="swiglu",
    norm="layernorm",
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
