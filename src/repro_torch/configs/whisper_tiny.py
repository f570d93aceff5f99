"""whisper-tiny [audio]: enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified]  4L dec (+4L enc) d_model=384 6H (kv=6)
d_ff=1536 vocab=51865."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="encdec",
    n_layers=4,
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    rope_theta=0.0,          # sinusoidal absolute positions
    tie_embeddings=True,
    n_audio_frames=1500,
)

SMOKE = ModelConfig(
    arch_id="whisper-tiny-smoke",
    family="encdec",
    n_layers=2,
    n_encoder_layers=2,
    d_model=32,
    n_heads=2,
    n_kv_heads=2,
    d_ff=64,
    vocab=96,
    act="gelu",
    norm="layernorm",
    rope_theta=0.0,
    tie_embeddings=True,
    n_audio_frames=12,
    param_dtype="float32",
    compute_dtype="float32",
)
