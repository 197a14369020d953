"""Model configuration for all assigned architectures.

One :class:`ModelConfig` describes any architecture in the pool: dense
decoder LMs, fine-grained MoE (optionally with MLA attention), pure-SSM
(Mamba2/SSD), hybrid SSM+shared-attention (Zamba2), encoder-decoder audio
(Whisper, stub frontend) and VLM (PaliGemma, stub vision tower).

A copy of the reference's jax-free ``repro.models.config``: importing it
from there would import ``repro.models.model``, and with it jax.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str = "dense"          # dense | moe | ssm | hybrid | audio | vlm

    # backbone
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"       # swiglu | relu2 | gelu
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # MoE
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0           # per-expert intermediate size
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25   # train default; serving uses higher

    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0          # 0 -> standard GQA attention
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # hybrid (Zamba2): one shared attention block applied every
    # ``attn_every`` SSM blocks.
    attn_every: int = 0

    # encoder-decoder (Whisper)
    n_enc_layers: int = 0
    enc_ctx: int = 1500            # frame embeddings from the (stub) frontend

    # VLM (PaliGemma)
    n_img_tokens: int = 0          # patch embeddings from the (stub) tower

    # numerics / execution
    dtype: str = "bfloat16"
    attn_impl: str = "chunked"     # naive | chunked (online-softmax scan)
    attn_chunk: int = 1024
    remat: bool = True

    # ---- derived ---------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_moe(self) -> bool:
        return self.n_routed_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter / FLOP counts (for roofline hygiene) ----------
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb

        hd = self.resolved_head_dim

        def attn_params() -> int:
            if self.kv_lora_rank:
                q = d * self.n_heads * (self.nope_head_dim + self.rope_head_dim)
                kv_a = d * (self.kv_lora_rank + self.rope_head_dim)
                kv_b = self.kv_lora_rank * self.n_heads * (
                    self.nope_head_dim + self.v_head_dim
                )
                o = self.n_heads * self.v_head_dim * d
                return q + kv_a + kv_b + o
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def mlp_params() -> int:
            mult = 3 if self.mlp_kind == "swiglu" else 2
            return mult * d * self.d_ff

        def moe_params() -> int:
            e_ff = self.d_ff_expert or self.d_ff
            routed = self.n_routed_experts * 3 * d * e_ff
            shared = self.n_shared_experts * 3 * d * e_ff
            router = d * self.n_routed_experts
            return routed + shared + router

        def ssm_params() -> int:
            di = self.d_inner
            n = self.ssm_state
            h = self.n_ssm_heads
            in_proj = d * (2 * di + 2 * n + h)  # x, z, B, C, dt
            conv = (di + 2 * n) * self.ssm_conv
            out = di * d
            extra = 2 * h + di  # A_log, D, norm
            return in_proj + conv + out + extra

        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn_params() + mlp_params())
        elif self.family == "moe":
            total += self.n_layers * (attn_params() + moe_params())
        elif self.family == "ssm":
            total += self.n_layers * ssm_params()
        elif self.family == "hybrid":
            n_attn_pos = self.n_layers // (self.attn_every or self.n_layers)
            n_ssm = self.n_layers - n_attn_pos
            total += n_ssm * ssm_params()
            total += attn_params() + mlp_params()  # ONE shared block
        elif self.family == "audio":
            total += self.n_enc_layers * (attn_params() + mlp_params())
            # decoder layers have self- + cross-attention
            total += self.n_layers * (2 * attn_params() + mlp_params())
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE activates top_k + shared)."""
        if not self.is_moe:
            return self.param_count()
        e_ff = self.d_ff_expert or self.d_ff
        inactive = (self.n_routed_experts - self.top_k) * 3 * self.d_model * e_ff
        return self.param_count() - self.n_layers * inactive

    def model_flops(self, tokens: int, *, training: bool = True) -> float:
        """6·N_active·D (plus attention quadratic term is ignored, matching
        the assignment's MODEL_FLOPS definition)."""
        mult = 6.0 if training else 2.0
        return mult * self.active_param_count() * tokens


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str = "train"            # train | prefill | decode
    note: str = ""


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec(
        "long_500k", 524_288, 1, "decode",
        note="sub-quadratic archs only (SSM/hybrid)",
    ),
}
