"""zamba2-7b [arXiv:2411.15242]

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64 —
Mamba2 blocks + ONE shared attention+MLP block applied every 6th position
(weight reuse across applications), our layout for the Zamba2 shared-block
architecture: 13 x [5 SSM + shared attn] + 3 trailing SSM = 81 blocks.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab=32_000,
    mlp_kind="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
)

SMOKE = CONFIG.replace(
    name="zamba2-7b-smoke",
    n_layers=7,          # 1 group of 5 SSM + shared attn + 1 trailing SSM
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=32,
    attn_every=6,
    attn_chunk=64,
)
