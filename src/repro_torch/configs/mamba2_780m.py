"""mamba2-780m [arXiv:2405.21060]

48L d_model=1536 (attention-free) vocab=50280, ssm_state=128 — SSD.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="mamba2-780m-smoke",
    n_layers=2,
    d_model=64,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=32,
)
