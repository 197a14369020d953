"""phi4-mini-3.8b [arXiv:2412.08905]

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200_064,
    mlp_kind="swiglu",
)

SMOKE = CONFIG.replace(
    name="phi4-mini-3.8b-smoke",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    attn_chunk=64,
)
