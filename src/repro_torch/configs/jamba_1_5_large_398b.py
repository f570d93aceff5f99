"""jamba-1.5-large-398b [hybrid]: Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]
72L d_model=8192 64H (kv=8) d_ff=24576 vocab=65536, MoE 16e top-2."""
from ..models.config import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid_jamba",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=0.0,          # jamba: no positional encoding (mamba provides order)
    attn_period=8,           # 1 attention layer per 8 (1:7)
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, layout="odd"),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)

SMOKE = ModelConfig(
    arch_id="jamba-1.5-large-398b-smoke",
    family="hybrid_jamba",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=128,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=0.0,
    attn_period=4,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96, layout="odd"),
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
    param_dtype="float32",
    compute_dtype="float32",
)
