"""qwen2.5-14b [hf:Qwen/Qwen2.5-*]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 — GQA with QKV bias.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13_824,
    vocab=152_064,
    qkv_bias=True,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    name="qwen2.5-14b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=512,
    attn_chunk=64,
)
