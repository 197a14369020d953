"""The LM stack: configs, layers, the SSM blocks and the unified LM
assembly (every family of the reference's), and the converter from the
reference's parameters.

The reference's ``sharding`` module holds hints that are no-ops without a
mesh; its counterpart waits for ROADMAP.md's multi-card queue item.
"""

from .config import ModelConfig, SHAPES, ShapeSpec  # noqa: F401
from .model import LM  # noqa: F401
from . import convert, layers, moe, ssm  # noqa: F401

__all__ = ["ModelConfig", "SHAPES", "ShapeSpec", "LM",
           "convert", "layers", "moe", "ssm"]
