"""deepseek-v2-lite-16b [arXiv:2405.04434; hf]

27L d_model=2048 16H d_ff=1408 vocab=102400, MLA kv_lora=512,
MoE: 2 shared + 64 routed, top-6.  (The assignment bracket mentions "160
routed" — that is the full V2; V2-Lite has 64 routed experts, matching the
"MoE 64e top-6" field.  We follow the 64e field; see DESIGN.md.)
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102_400,
    mlp_kind="swiglu",
    n_routed_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
)

SMOKE = CONFIG.replace(
    name="deepseek-v2-lite-16b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    d_ff_expert=128,
    n_routed_experts=8,
    top_k=2,
    vocab=512,
    kv_lora_rank=32,
    rope_head_dim=8,
    nope_head_dim=16,
    v_head_dim=16,
    attn_chunk=64,
)
