"""nemotron-4-340b [arXiv:2402.16819]

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000 —
GQA + squared-ReLU MLP (no gate).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab=256_000,
    mlp_kind="relu2",
)

SMOKE = CONFIG.replace(
    name="nemotron-4-340b-smoke",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=384,
    vocab=512,
    attn_chunk=64,
)
