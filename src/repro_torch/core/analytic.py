"""Analytic FLOP / HBM-byte / collective-byte model per cell.

XLA's ``cost_analysis()`` does not multiply through ``while`` loops (our
layer scans and microbatch accumulation), so compiled numbers undercount by
the trip counts.  The roofline therefore uses this analytic model as the
primary source — the standard LLM-roofline accounting — and keeps the
HLO-derived numbers as per-iteration schedule evidence.

Conventions:

- FLOPs are global per step (2 FLOPs per MAC).  Training = 3x forward
  (activation + weight gradient matmuls).
- HBM bytes are global per step: weight traffic (per microbatch pass),
  activation write+read traffic at bf16, optimizer f32 traffic, KV/state
  cache traffic.
- Collective bytes are **summed per-chip link traffic x chips** (so
  ``t_coll = bytes / (chips * link_bw)`` is the per-chip link time):
  ring all-reduce of G bytes over n chips counts ~2G per chip.

Approximations are coarse (±30%) but consistent across candidate
implementations — which is what the hillclimb needs (term *identification*
and *relative* movement).

A copy of the reference's ``repro.core.analytic`` over the port's
``models.config``: pure arithmetic, held equal float for float (``notes``
included) by the tests.  In the port, the dry run's record of dispatched
ops stands where the reference keeps its per-iteration HLO numbers
(``repro_torch.launch.dryrun``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ModelConfig, ShapeSpec

__all__ = ["CellCost", "cell_cost"]

BF16 = 2
F32 = 4


@dataclass
class CellCost:
    flops: float
    hbm_bytes: float
    collective_bytes: float     # chips x per-chip link bytes
    notes: dict


def _attn_dims(cfg: ModelConfig):
    if cfg.kv_lora_rank:
        d_attn = cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
        kv_row = cfg.kv_lora_rank + cfg.rope_head_dim        # latent cache row
    else:
        d_attn = cfg.n_heads * cfg.resolved_head_dim
        kv_row = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
    return d_attn, kv_row


def _n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    if cfg.family == "audio":
        return cfg.n_layers + cfg.n_enc_layers  # (+ cross handled separately)
    return cfg.n_layers


def _n_ssm_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers - cfg.n_layers // cfg.attn_every
    return 0


def _nonembed_active(cfg: ModelConfig) -> int:
    emb_in = cfg.vocab * cfg.d_model
    return max(cfg.active_param_count() - 2 * emb_in
               if not cfg.tie_embeddings else
               cfg.active_param_count() - emb_in, 0)


def cell_cost(cfg: ModelConfig, shape: ShapeSpec, *, kind: str,
              microbatches: int, data_shards: int, model_shards: int,
              expert_sharded: bool = True,
              infer_fsdp: bool = False) -> CellCost:
    b, s = shape.global_batch, shape.seq_len
    tokens = b * (1 if kind == "decode" else s)
    ctx = s if kind == "decode" else s / 2          # avg causal context
    d = cfg.d_model
    d_attn, kv_row = _attn_dims(cfg)
    n_attn = _n_attn_layers(cfg)
    n_ssm = _n_ssm_layers(cfg)
    chips = data_shards * model_shards

    # ---------------- FLOPs ----------------
    matmul = 2.0 * _nonembed_active(cfg) * tokens
    head = 2.0 * d * cfg.vocab * tokens
    attn = 4.0 * d_attn * ctx * n_attn * tokens
    if cfg.family == "audio":
        # cross-attention context is the encoder length (decoder layers)
        attn += 4.0 * d_attn * cfg.enc_ctx * cfg.n_layers * tokens
        # encoder processes enc_ctx frames per example, not `tokens`
    ssd = 0.0
    if n_ssm:
        q = min(cfg.ssm_chunk, s)
        n_state = cfg.ssm_state
        hp = cfg.d_inner
        per_tok = 2 * q * n_state + 2 * q * hp + 4 * n_state * hp
        ssd = per_tok * n_ssm * tokens
    fwd = matmul + head + attn + ssd
    flops = 3.0 * fwd if kind == "train" else fwd

    # ---------------- HBM bytes ----------------
    p_total = cfg.param_count()
    p_active = cfg.active_param_count()
    # decode touches only experts hit by this batch
    if kind == "decode" and cfg.is_moe:
        e, k = cfg.n_routed_experts, cfg.top_k
        coverage = 1.0 - (1.0 - k / e) ** b
        routed = cfg.n_layers * cfg.n_routed_experts * 3 * d * (
            cfg.d_ff_expert or cfg.d_ff)
        p_touch = p_total - routed + routed * coverage
    else:
        # training/prefill touch every expert (tokens spread over experts)
        p_touch = p_total if cfg.is_moe else p_active

    act_row = d * BF16
    if kind == "train":
        weight_traffic = microbatches * 2.0 * p_touch * BF16   # fwd + bwd read
        opt_traffic = p_total * (F32 * 3 + BF16 * 3)           # p,m,v r/w + grads
        # activations: ~6 tensor r/w per layer with remat recompute (x2 fwd)
        act_traffic = tokens * act_row * (n_attn + n_ssm) * 8.0
        logits_traffic = tokens * cfg.vocab * BF16             # chunked head
        kv_traffic = 0.0
    elif kind == "prefill":
        weight_traffic = p_touch * BF16
        opt_traffic = 0.0
        act_traffic = tokens * act_row * (n_attn + n_ssm) * 4.0
        logits_traffic = b * cfg.vocab * F32                   # last-token only
        kv_traffic = tokens * kv_row * BF16 * n_attn           # cache writes
    else:  # decode
        weight_traffic = p_touch * BF16
        opt_traffic = 0.0
        act_traffic = tokens * act_row * (n_attn + n_ssm) * 4.0
        logits_traffic = b * cfg.vocab * F32
        # the whole KV cache is read once per step (+ SSM state r/w)
        kv_traffic = b * s * kv_row * BF16 * n_attn
        if n_ssm:
            state = b * cfg.n_ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * F32
            kv_traffic += 2.0 * state * n_ssm
    hbm = weight_traffic + opt_traffic + act_traffic + logits_traffic + kv_traffic

    # ---------------- collective bytes (chips x per-chip link traffic) ----
    per_chip = 0.0
    # Inference keeps weights resident (model-axis sharding only): no
    # per-step FSDP gather — except cells flagged infer_fsdp (weights too
    # large for model-axis-only HBM; pay a per-step gather).
    fsdp_shards = data_shards if (kind == "train" or infer_fsdp) else 1
    # Params are 2D-sharded (fsdp x model): the fsdp all-gather moves only
    # the model-shard-local slice of the weights onto each chip.
    p_local = p_total / max(1, model_shards)
    if fsdp_shards > 1 and kind == "train":
        # FSDP all-gather per microbatch (fwd + bwd) + grad reduce-scatter
        per_chip += microbatches * 2.0 * p_local * BF16
        per_chip += p_local * BF16
    if fsdp_shards > 1 and kind != "train":
        per_chip += p_local * BF16  # weight all-gather once per step
    if model_shards > 1:
        tok_per_data_shard = tokens / max(1, data_shards)
        passes = 3.0 if kind == "train" else 1.0
        # TP activation all-reduce: ~2 per layer (attn out + mlp out), ring 2x
        per_chip += (4.0 * tok_per_data_shard * act_row
                     * (n_attn + n_ssm) * passes)
        if cfg.is_moe and expert_sharded:
            # token all-to-all there+back per MoE layer (a2a moves each
            # byte once: (n-1)/n of tokens leave the chip)
            per_chip += (2.0 * tok_per_data_shard * act_row
                         * cfg.top_k / max(cfg.top_k, 1)
                         * cfg.n_layers * passes)
    coll = per_chip * chips

    return CellCost(
        flops=flops,
        hbm_bytes=hbm,
        collective_bytes=coll,
        notes={
            "matmul_flops": matmul, "attn_flops": attn, "ssd_flops": ssd,
            "head_flops": head,
            "weight_traffic": weight_traffic, "opt_traffic": opt_traffic,
            "act_traffic": act_traffic, "kv_traffic": kv_traffic,
            "logits_traffic": logits_traffic,
            "p_total": p_total, "p_active": p_active, "p_touch": p_touch,
        },
    )
