"""The LM stack: configs, layers and the unified LM assembly (the
``dense``, ``moe`` and ``vlm`` families), and the converter from the
reference's parameters.

The reference's ``sharding`` module holds hints that are no-ops without a
mesh, and has no counterpart; ``ssm`` waits for ROADMAP.md's "LM stack,
1b".
"""

from .config import ModelConfig, SHAPES, ShapeSpec  # noqa: F401
from .model import LM  # noqa: F401
from . import convert, layers, moe  # noqa: F401

__all__ = ["ModelConfig", "SHAPES", "ShapeSpec", "LM",
           "convert", "layers", "moe"]
