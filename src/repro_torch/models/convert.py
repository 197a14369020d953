"""Parameters carried between the reference's pytree and the port's LM.

The reference's ``LM.init`` returns a nested dict whose layer leaves are
stacked on a leading axis (``layers.attn.wq`` is [L, d, h, hd]; the
hybrid's ``ssm_groups.ssm.w_in`` is stacked twice, [g, per, d, ...]); the
port's :class:`~repro_torch.models.model.LM` names the same tensors
``layers.{i}.attn.wq`` and ``ssm_groups.{g}.{i}.ssm.w_in``.
``from_reference`` takes that pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``), splits each stacked leaf along its
stacked axes and copies every leaf into the LM, consuming each exactly
once; ``to_reference`` joins them back.  A round trip is exact, byte for
byte.

``split_tree`` and ``join_tree`` do the same for any tree of the
parameters' structure (the optimizer's moments, the error-feedback
buffers) with numpy arrays or torch tensors of any dtype; ``tree_order``
sorts the port's names into the order of the reference's leaves
(``jax.tree.flatten`` sorts dict keys, and a stacked leaf holds its layers
in index order).
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Mapping

import numpy as np
import torch

from .config import ModelConfig
from .model import LM, hybrid_layout

__all__ = ["from_reference", "to_reference", "split_tree", "join_tree",
           "reference_key", "tree_order"]

# the port's stacks of layers and how many axes the reference stacks
# them on
_DEPTH = {"layers": 1, "enc_layers": 1, "ssm_tail": 1, "ssm_groups": 2}


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for name, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = v
    return out


def reference_key(name: str) -> tuple[str, tuple[int, ...]]:
    """``ssm_groups.3.2.ssm.w_in`` -> (``ssm_groups.ssm.w_in``, (3, 2));
    ``layers.5.attn.wq`` -> (``layers.attn.wq``, (5,)); others unchanged
    with ()."""
    parts = name.split(".")
    depth = _DEPTH.get(parts[0], 0)
    idx = tuple(int(i) for i in parts[1:1 + depth])
    return ".".join([parts[0]] + parts[1 + depth:]), idx


def tree_order(names: Iterable[str]) -> list[str]:
    """``names`` in the order of the reference's flattened leaves."""
    def key(n):
        ref, idx = reference_key(n)
        return tuple(ref.split(".")), idx
    return sorted(names, key=key)


def _stack_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    if cfg.family == "hybrid":
        g, per, trailing = hybrid_layout(cfg)
        return {"ssm_groups": (g, per), "ssm_tail": (trailing,)}
    out = {"layers": (cfg.n_layers,)}
    if cfg.family == "audio":
        out["enc_layers"] = (cfg.n_enc_layers,)
    return out


def split_tree(tree: Mapping, names: Iterable[str],
               cfg: ModelConfig) -> dict:
    """The leaves of a tree in the reference's layout, cut into the port's
    ``names`` (views of the stacked leaves, numpy or torch alike).

    Raises ``KeyError`` when a name has no leaf, or the tree a leaf no name
    takes, and ``ValueError`` when a leaf's stacked axes differ from
    ``cfg``'s."""
    leaves = _flatten(tree)
    stacks = _stack_shapes(cfg)
    out, used = {}, set()
    for name in names:
        ref, idx = reference_key(name)
        if ref not in leaves:
            raise KeyError(f"the reference's tree has no {ref!r} "
                           f"(for {name})")
        leaf = leaves[ref]
        if idx:
            want = stacks[ref.split(".")[0]]
            if tuple(leaf.shape[:len(idx)]) != want:
                raise ValueError(f"{ref}: stacked on "
                                 f"{tuple(leaf.shape[:len(idx)])}, expected "
                                 f"{want}")
            leaf = leaf[idx]
        out[name] = leaf
        used.add(ref)
    extra = sorted(set(leaves) - used)
    if extra:
        raise KeyError(f"the LM takes no parameter {extra}")
    return out


def join_tree(named: Mapping[str, object],
              stack: Callable = np.stack) -> dict:
    """The port's named leaves as the reference's nested tree, stacked
    leaves joined along their leading axes with ``stack`` (``np.stack``
    or ``torch.stack``)."""
    groups: dict[str, dict] = {}
    for name, v in named.items():
        ref, idx = reference_key(name)
        groups.setdefault(ref, {})[idx] = v

    def build(items: dict, depth: int):
        if depth == 0:
            return items[()]
        heads = sorted({i[0] for i in items})
        return stack([build({i[1:]: v for i, v in items.items()
                             if i[0] == h}, depth - 1) for h in heads])

    tree: dict = {}
    for ref, items in groups.items():
        *path, leaf = ref.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = build(items, len(next(iter(items))))
    return tree


def from_reference(params: Mapping, cfg: ModelConfig,
                   device: str | torch.device = "cuda") -> LM:
    """An :class:`LM` on ``device`` holding the reference's parameters.

    Raises ``KeyError`` when the LM has a parameter the pytree lacks, or
    the pytree a leaf the LM does not take, and ``ValueError`` on a shape
    or dtype that differs."""
    lm = LM(cfg, device=device)
    named = dict(lm.named_parameters())
    leaves = split_tree(params, named, cfg)
    with torch.no_grad():
        for name, p in named.items():
            leaf = np.asarray(leaves[name])
            if leaf.shape != tuple(p.shape) or leaf.dtype != np.float32:
                raise ValueError(f"{reference_key(name)[0]}: {leaf.dtype}"
                                 f"{list(leaf.shape)} does not fit {name}'s "
                                 f"float32{list(p.shape)}")
            p.copy_(torch.from_numpy(np.array(leaf, copy=True)))
    return lm


def to_reference(lm: LM) -> dict:
    """The LM's parameters as the reference's pytree of numpy arrays,
    layer leaves stacked on their leading axes."""
    return join_tree({name: p.detach().cpu().numpy().copy()
                      for name, p in lm.named_parameters()})
