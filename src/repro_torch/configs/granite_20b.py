"""granite-20b [arXiv:2405.04324]

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 — llama-arch, code.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab=49_152,
    mlp_kind="swiglu",
)

SMOKE = CONFIG.replace(
    name="granite-20b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=192,
    vocab=512,
    attn_chunk=64,
)
