"""deepseek-moe-16b [arXiv:2401.06066; hf]

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE: 2 shared + 64 routed experts, top-6, fine-grained (d_ff_expert=1408).
(The real model keeps layer 0 dense; we use a uniform MoE stack to keep the
layer scan homogeneous — noted in DESIGN.md §Assumptions.)
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
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
)

SMOKE = CONFIG.replace(
    name="deepseek-moe-16b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    d_ff_expert=128,
    n_routed_experts=8,
    top_k=2,
    vocab=512,
    attn_chunk=64,
)
