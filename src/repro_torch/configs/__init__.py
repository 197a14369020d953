"""Architecture registry: exact public configs + reduced smoke variants.

A copy of the reference's ``repro.configs`` (configs are data): the same
ten ``CONFIG``/``SMOKE`` pairs, held equal field by field by the tests.

``get(name)`` returns the full assigned config; ``get_smoke(name)`` returns
a same-family reduced config that runs a forward/train step on CPU in
seconds (small layers/width, few experts, tiny vocab).
"""

from __future__ import annotations

from ..models.config import ModelConfig, SHAPES, ShapeSpec  # noqa: F401

from . import (
    deepseek_moe_16b,
    deepseek_v2_lite_16b,
    qwen2_5_14b,
    phi4_mini_3_8b,
    nemotron_4_340b,
    granite_20b,
    zamba2_7b,
    mamba2_780m,
    whisper_large_v3,
    paligemma_3b,
)

_MODULES = {
    "deepseek-moe-16b": deepseek_moe_16b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "qwen2.5-14b": qwen2_5_14b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "nemotron-4-340b": nemotron_4_340b,
    "granite-20b": granite_20b,
    "zamba2-7b": zamba2_7b,
    "mamba2-780m": mamba2_780m,
    "whisper-large-v3": whisper_large_v3,
    "paligemma-3b": paligemma_3b,
}

ARCHS = tuple(_MODULES)


def get(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].SMOKE


def shapes_for(name: str) -> tuple[str, ...]:
    """Applicable shape cells for an architecture (assignment rules):

    - ``long_500k`` runs only for sub-quadratic archs (SSM / hybrid);
      pure full-attention archs skip it (noted in DESIGN.md).
    - every arch runs train_4k / prefill_32k / decode_32k (decoder exists
      for all ten: whisper/paligemma decode exercises the backbone).
    """
    cfg = get(name)
    base = ("train_4k", "prefill_32k", "decode_32k")
    if cfg.family in ("ssm", "hybrid"):
        return base + ("long_500k",)
    return base
