"""Step builders and input specs per cell, on DTensor (the port of
``repro.launch.specs``).

:func:`build_cell` places a cell's LM, optimizer state, caches and batch
on a ``DeviceMesh`` as DTensors, each leaf laid out by its logical axes
through the cell's rules (``repro_torch.models.sharding``):

- on the production mesh (a fake process group,
  ``launch.mesh.make_production_mesh``) every leaf is a ``meta`` DTensor
  made with ``DTensor.from_local`` from its local shard's shape — shapes
  without memory, which is what lets the 340B config run its step on one
  host (the reference's ``jax.eval_shape``);
- on a local mesh (``launch.mesh.make_local_mesh``) the same placements
  hold real tensors: parameters drawn from seed 0 as ``LM.init`` draws
  them, then the caches (standard normal) and the batch (tokens, decode
  positions) from the same generator.

Serving cells carry their weights in the config's compute dtype (bf16),
as the reference's ``build_cell`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import sharding
from repro_torch.models.shard_ops import contiguous_stride
from repro_torch.models.model import LM
from repro_torch.models.sharding import (DEFAULT_RULES, INFER_RULES,
                                         tree_shardings)
from repro_torch.train import AdamWConfig, build_train_step

from .cells import CellPlan

__all__ = ["build_cell", "input_specs", "rules_for", "InputSpec",
           "is_abstract", "local_bytes", "plain_lm", "leaves", "flat_axes"]


@dataclass(frozen=True)
class InputSpec:
    """The port's ``jax.ShapeDtypeStruct``."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def input_specs(plan: CellPlan) -> dict[str, InputSpec]:
    """Shape and dtype of every model input of this cell."""
    cfg, shape = plan.cfg, plan.shape
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    i32 = torch.int32

    if plan.kind in ("train", "prefill"):
        specs = {"tokens": InputSpec((b, s), i32)}
        if plan.kind == "train":
            specs["labels"] = InputSpec((b, s), i32)
        if cfg.family == "vlm":
            specs["extra_embed"] = InputSpec((b, cfg.n_img_tokens,
                                              cfg.d_model), dt)
        if cfg.family == "audio":
            specs["extra_embed"] = InputSpec((b, cfg.enc_ctx, cfg.d_model),
                                             dt)
        return specs

    # decode: one new token against a KV cache of seq_len
    return {"tokens": InputSpec((b, 1), i32), "pos": InputSpec((b,), i32)}


def rules_for(kind: str, override: dict | None = None) -> dict:
    base = DEFAULT_RULES if kind == "train" else INFER_RULES
    return dict(base, **override) if override else base


def is_abstract(mesh) -> bool:
    """True on a mesh over the fake process group: leaves are ``meta``."""
    import torch.distributed as dist

    return dist.get_backend(mesh.get_group(0)) == "fake"


def local_bytes(tree) -> int:
    """Σ over a tree's tensors of their local shards' bytes."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in leaves(tree):
        loc = t._local_tensor if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def leaves(tree):
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)


class _Placer:
    """Makes the DTensors of one cell: ``meta`` shards on an abstract
    mesh, real ones drawn from one generator seeded 0 otherwise."""

    def __init__(self, mesh, device: torch.device):
        self.mesh = mesh
        self.device = device
        self.abstract = device.type == "meta"
        self.gen = None if self.abstract else \
            torch.Generator(device=device).manual_seed(0)

    def place(self, full: torch.Tensor | None, shape, dtype,
              ns: sharding.NamedSharding):
        """A DTensor of global ``shape``: from ``full`` (the global
        tensor, every rank holding the same one), or empty shards."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        pl = ns.placements
        if full is not None:
            return distribute_tensor(full.to(dtype), self.mesh, pl,
                                     src_data_rank=None)
        local = torch.empty(ns.shard_shape(shape), dtype=dtype,
                            device=self.device)
        return DTensor.from_local(local, self.mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    def tensor(self, shape, dtype, ns, kind: str, high: int = 0):
        """A leaf drawn from the generator (``normal``, ``zeros`` or
        ``randint`` below ``high``), or an empty shard on ``meta``."""
        if self.abstract:
            return self.place(None, shape, dtype, ns)
        if kind == "zeros":
            full = torch.zeros(shape, dtype=dtype, device=self.device)
        elif kind == "randint":
            full = torch.randint(0, high, shape, generator=self.gen,
                                 dtype=dtype, device=self.device)
        else:
            full = torch.randn(shape, generator=self.gen,
                               dtype=torch.float32, device=self.device)
        return self.place(full, shape, dtype, ns)


def _module_of(lm: LM, name: str):
    mod = lm
    *path, leaf = name.split(".")
    for part in path:
        mod = getattr(mod, part)
    return mod, leaf


def flat_axes(tree, prefix: str = "") -> dict[str, tuple]:
    """``LM.axes()`` flattened to the LM's parameter names."""
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flat_axes(v, f"{prefix}{k}."))
        else:
            out[prefix + str(k)] = v
    return out


def _place_lm(plan: CellPlan, mesh, rules, placer: _Placer) -> tuple[LM, dict]:
    """The cell's LM with every parameter replaced by a DTensor parameter
    laid out by its axes; returns (lm, {name: NamedSharding})."""
    from repro_torch.capture.zoo import meta_lm

    cfg = plan.cfg
    if placer.abstract:
        lm = meta_lm(cfg)
    else:
        lm = LM(cfg, device=placer.device).init(placer.gen)
    # serving loads bf16 weights (half the HBM and gather bytes)
    dt = torch.float32 if plan.kind == "train" else getattr(torch, cfg.dtype)
    axes = flat_axes(lm.axes())
    shardings = {}
    with torch.no_grad():
        for name, p in list(lm.named_parameters()):
            ns = sharding.named_sharding(mesh, axes[name], tuple(p.shape),
                                         rules)
            shardings[name] = ns
            d = placer.place(None if placer.abstract else p, tuple(p.shape),
                             dt if p.dtype == torch.float32 else p.dtype, ns)
            mod, leaf = _module_of(lm, name)
            setattr(mod, leaf, torch.nn.Parameter(d, requires_grad=False))
    return lm, shardings


def _batch_shardings(mesh, specs, rules):
    return {k: sharding.named_sharding(
                mesh, ("batch",) + (None,) * (len(v.shape) - 1), v.shape,
                rules)
            for k, v in specs.items()}


def _batch(placer: _Placer, specs, shardings, vocab: int, pos_high: int):
    """Tokens and labels below ``vocab``, decode positions below
    ``pos_high``, frame or patch embeddings standard normal."""
    highs = {"tokens": vocab, "labels": vocab, "pos": pos_high}
    return {k: placer.tensor(v.shape, v.dtype, shardings[k],
                             "randint" if k in highs else "normal",
                             highs.get(k, 0))
            for k, v in specs.items()}


def _cache(lm: LM, placer: _Placer, mesh, rules, batch: int, max_len: int):
    shapes = lm.init_cache(batch, max_len, device="meta")
    cache_sh = tree_shardings(mesh, shapes, lm.cache_axes(), rules)

    def build(sh, ns):
        if isinstance(sh, dict):
            return {k: build(sh[k], ns[k]) for k in sh}
        return placer.tensor(tuple(sh.shape), sh.dtype, ns, "normal")

    return build(shapes, cache_sh), cache_sh


def build_cell(plan: CellPlan, mesh, *, opt_cfg: AdamWConfig | None = None,
               rules: dict | None = None):
    """Return ``(fn, args, shardings, donate, rules)`` for one cell:
    ``fn(*args)`` runs the cell's step once under
    ``sharding.activate(mesh, rules)`` and DTensor's
    ``implicit_replication`` (constants the model makes inside are
    replicated), ``shardings`` mirrors ``args`` with a
    :class:`~repro_torch.models.sharding.NamedSharding` a leaf.

    The LM holds the parameters: ``args[0]`` is its parameter dict (the
    same tensors).  A train step updates them, and the optimizer state,
    in place; prefill and decode write the cache in place."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = plan.cfg
    rules = rules_for(plan.kind, rules or dict(plan.rules_override))
    device = torch.device("meta") if is_abstract(mesh) else \
        torch.device(mesh.device_type, torch.cuda.current_device()
                     if mesh.device_type == "cuda" else None)
    placer = _Placer(mesh, device)
    lm, param_sh = _place_lm(plan, mesh, rules, placer)
    params = dict(lm.named_parameters())
    specs = input_specs(plan)
    batch_sh = _batch_shardings(mesh, specs, rules)
    b, s = plan.shape.global_batch, plan.shape.seq_len

    def running(step: Callable) -> Callable:
        def fn(*args):
            with sharding.activate(mesh, rules), implicit_replication():
                return step(*args)
        return fn

    if plan.kind == "train":
        # the moments shard like their parameters, the step count is
        # replicated (``train.optimizer.opt_state_axes``)
        opt_cfg = opt_cfg or AdamWConfig()
        sdt = getattr(torch, opt_cfg.state_dtype)
        opt_sh = {"adam": {"mu": param_sh, "nu": param_sh,
                           "step": sharding.named_sharding(mesh, (), (),
                                                           rules)}}
        opt_state = {"adam": {
            m: {n: placer.tensor(tuple(p.shape), sdt, param_sh[n], "zeros")
                for n, p in params.items()} for m in ("mu", "nu")}}
        opt_state["adam"]["step"] = placer.tensor(
            (), torch.int32, opt_sh["adam"]["step"], "zeros")
        batch = _batch(placer, specs, batch_sh, cfg.vocab, s)
        step = build_train_step(lm, opt_cfg, microbatches=plan.microbatches)

        def train(params, opt_state, batch):
            return step(opt_state, batch)

        return (running(train), (params, opt_state, batch),
                (param_sh, opt_sh, batch_sh), (0, 1), rules)

    if plan.kind == "prefill":
        # VLM prefill caches image-prefix positions too
        extra = cfg.n_img_tokens if cfg.family == "vlm" else 0
        cache, cache_sh = _cache(lm, placer, mesh, rules, b, s + extra + 1)
        batch = _batch(placer, specs, batch_sh, cfg.vocab, s)

        def prefill(params, batch, cache):
            return lm.prefill(batch["tokens"], cache,
                              extra_embed=batch.get("extra_embed"))

        return (running(prefill), (params, batch, cache),
                (param_sh, batch_sh, cache_sh), (2,), rules)

    # decode
    cache, cache_sh = _cache(lm, placer, mesh, rules, b, s)
    batch = _batch(placer, specs, batch_sh, cfg.vocab, s)

    def decode(params, tokens, cache, pos):
        return lm.decode_step(tokens, cache, pos)

    return (running(decode), (params, batch["tokens"], cache, batch["pos"]),
            (param_sh, batch_sh["tokens"], cache_sh, batch_sh["pos"]), (2,),
            rules)


def plain_lm(cfg, params: dict, device) -> LM:
    """An LM of ``cfg`` on ``device`` whose parameters are the local
    tensors of ``params`` (``build_cell``'s ``args[0]``), shared, not
    copied: on a one-rank mesh, the placed LM's own weights as plain
    tensors."""
    from torch.distributed.tensor import DTensor

    lm = LM(cfg, device=device)
    with torch.no_grad():
        for name, p in params.items():
            t = p.to_local() if isinstance(p, DTensor) else p
            mod, leaf = _module_of(lm, name)
            setattr(mod, leaf, torch.nn.Parameter(t.detach(),
                                                  requires_grad=False))
    return lm
