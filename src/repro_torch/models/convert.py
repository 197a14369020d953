"""Parameters carried between the reference's pytree and the port's LM.

The reference's ``LM.init`` returns a nested dict whose layer leaves are
stacked on a leading axis of ``n_layers`` (``layers.attn.wq`` is [L, d,
h, hd]); the port's :class:`~repro_torch.models.model.LM` names the same
tensors ``layers.{i}.attn.wq``.  ``from_reference`` takes that pytree as
numpy arrays (``jax.tree.map(np.asarray, params)``), splits each stacked
leaf along axis 0 and copies every leaf into the LM, consuming each
exactly once; ``to_reference`` joins them back.  A round trip is exact,
byte for byte.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .config import ModelConfig
from .model import LM

__all__ = ["from_reference", "to_reference"]


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for name, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = np.asarray(v)
    return out


def _reference_name(name: str) -> tuple[str, int | None]:
    """``layers.3.attn.wq`` -> (``layers.attn.wq``, 3); others unchanged."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ".".join(["layers"] + parts[2:]), int(parts[1])
    return name, None


def from_reference(params: Mapping, cfg: ModelConfig,
                   device: str | torch.device = "cuda") -> LM:
    """An :class:`LM` on ``device`` holding the reference's parameters.

    Raises ``KeyError`` when the LM has a parameter the pytree lacks, or
    the pytree a leaf the LM does not take, and ``ValueError`` on a shape
    or dtype that differs."""
    leaves = _flatten(params)
    lm = LM(cfg, device=device)
    used: set[str] = set()
    for name, p in lm.named_parameters():
        ref, layer = _reference_name(name)
        if ref not in leaves:
            raise KeyError(f"the reference's parameters have no {ref!r} "
                           f"(for {name})")
        leaf = leaves[ref]
        if layer is not None:
            if leaf.shape[:1] != (cfg.n_layers,):
                raise ValueError(f"{ref}: stacked on {leaf.shape[:1]}, "
                                 f"expected ({cfg.n_layers},)")
            leaf = leaf[layer]
        if leaf.shape != tuple(p.shape) or leaf.dtype != np.float32:
            raise ValueError(f"{ref}: {leaf.dtype}{list(leaf.shape)} does "
                             f"not fit {name}'s float32{list(p.shape)}")
        p.copy_(torch.from_numpy(np.array(leaf, copy=True)))
        used.add(ref)
    extra = sorted(set(leaves) - used)
    if extra:
        raise KeyError(f"the LM takes no parameter {extra}")
    return lm


def to_reference(lm: LM) -> dict:
    """The LM's parameters as the reference's pytree of numpy arrays,
    layer leaves stacked on a leading axis."""
    flat: dict[str, list[np.ndarray] | np.ndarray] = {}
    for name, p in lm.named_parameters():
        ref, layer = _reference_name(name)
        arr = p.detach().cpu().numpy().copy()
        if layer is None:
            flat[ref] = arr
        else:
            flat.setdefault(ref, []).append(arr)
    tree: dict = {}
    for ref, v in flat.items():
        *path, leaf = ref.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.stack(v) if isinstance(v, list) else v
    return tree
