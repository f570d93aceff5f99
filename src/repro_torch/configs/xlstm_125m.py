"""xlstm-125m [ssm]: sLSTM + mLSTM blocks.  [arXiv:2405.04517; unverified]
12L d_model=768 4H (kv=4) d_ff=0 vocab=50304 (no separate FFN; capacity
lives in the blocks' internal projections)."""
from ..models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family="ssm_xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    norm="rmsnorm",
    rope_theta=0.0,
    tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=4),
)

SMOKE = ModelConfig(
    arch_id="xlstm-125m-smoke",
    family="ssm_xlstm",
    n_layers=4,
    d_model=32,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab=96,
    norm="rmsnorm",
    rope_theta=0.0,
    tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=4),
    param_dtype="float32",
    compute_dtype="float32",
)
