"""whisper-large-v3 [arXiv:2212.04356]

32L (enc) + 32L (dec) d_model=1280 20H d_ff=5120 vocab=51866 — enc-dec;
the conv/mel frontend is a STUB: input_specs() supplies 1500 precomputed
frame embeddings per example.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    n_enc_layers=32,
    enc_ctx=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51_866,
    mlp_kind="gelu",
)

SMOKE = CONFIG.replace(
    name="whisper-large-v3-smoke",
    n_layers=2,
    n_enc_layers=2,
    enc_ctx=32,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    attn_chunk=64,
)
