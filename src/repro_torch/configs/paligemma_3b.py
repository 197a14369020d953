"""paligemma-3b [arXiv:2407.07726; hf]

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216 — Gemma backbone;
the SigLIP vision tower is a STUB: input_specs() supplies 256 precomputed
patch embeddings per image.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16_384,
    vocab=257_216,
    mlp_kind="gelu",
    n_img_tokens=256,
    head_dim=256,
)

SMOKE = CONFIG.replace(
    name="paligemma-3b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=512,
    n_img_tokens=8,
    head_dim=16,
    attn_chunk=64,
)
