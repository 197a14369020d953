"""The train step: microbatched gradient accumulation, AdamW, metrics.

The port of ``repro.train.step``.  ``build_train_step(lm, opt_cfg)``
returns ``train_step(opt_state, batch) -> (opt_state, metrics)``, which
trains the LM's own parameters in place (the reference's step takes and
returns the parameter tree; here the LM holds it).  Microbatches are
leading splits of the batch, run one after another; their float32
gradients add up in order in ``.grad`` and are divided by their count,
then cast to ``grad_dtype`` before the optimizer, as the reference's are.
The metrics are tensors on the LM's device: the step never waits for the
card.

Trees (moments, error-feedback buffers) are flat dicts keyed by the LM's
parameter names; ``train_tree`` and ``load_train_tree`` carry the whole
training state to and from the reference's layout ({"params": ...,
"opt": {"adam": {"mu", "nu", "step"}, "err"}}, layer leaves stacked), the
tree its checkpoints hold.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.convert import join_tree, reference_key, split_tree
from repro_torch.models.model import LM

from . import compress as C
from . import optimizer as O

__all__ = ["build_train_step", "build_eval_step", "init_train_state",
           "train_state_axes", "train_params", "train_tree",
           "load_train_tree"]


def train_params(lm: LM) -> dict[str, torch.nn.Parameter]:
    """The LM's parameters by name, in the reference's leaf order."""
    return dict(O.leaves(dict(lm.named_parameters())))


def _split_batch(batch: dict, n: int) -> list[dict]:
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        assert b % n == 0, f"batch {b} not divisible by {n} microbatches"
        for i, part in enumerate(x.split(b // n)):
            out[i][k] = part
    return out


def build_train_step(lm: LM, opt_cfg: O.AdamWConfig, *,
                     microbatches: int = 1, grad_dtype: str = "bfloat16",
                     compress: str | None = None) -> Callable:
    """compress: None | "int8_ef" (error-feedback int8, see compress.py).
    Turns on ``requires_grad`` for the LM's parameters."""
    params = train_params(lm)
    for p in params.values():
        p.requires_grad_(True)
    gdt = getattr(torch, grad_dtype)

    def train_step(opt_state: dict, batch: dict) -> tuple[dict, dict]:
        for p in params.values():
            p.grad = None
        mbs = _split_batch(batch, microbatches) if microbatches > 1 \
            else [batch]
        loss = torch.zeros((), dtype=torch.float32, device=lm.device)
        with torch.enable_grad():
            for mb in mbs:
                l = lm.loss(mb)
                l.backward()
                loss = loss + l.detach()
        grads = {}
        for name, p in params.items():
            g = p.grad
            p.grad = None
            if microbatches > 1:
                g = g / microbatches
            grads[name] = g.to(gdt)
            del g
        if microbatches > 1:
            loss = loss / microbatches

        metrics = {"loss": loss}
        out_state = {}
        if compress == "int8_ef":
            grads, out_state["err"], cm = C.compress_decompress(
                grads, opt_state["err"])
            metrics.update(cm)
        elif "err" in opt_state:
            out_state["err"] = opt_state["err"]
        _, out_state["adam"], om = O.apply_updates(
            params, grads, opt_state["adam"], opt_cfg)
        metrics.update(om)
        return out_state, metrics

    return train_step


def init_train_state(lm: LM, opt_cfg: O.AdamWConfig, *,
                     compress: str | None = None) -> dict:
    params = train_params(lm)
    state = {"adam": O.init_opt_state(params, opt_cfg)}
    if compress == "int8_ef":
        state["err"] = C.init_error_buffers(params)
    return state


def train_state_axes(param_axes, *, compress: str | None = None) -> dict:
    state = {"adam": O.opt_state_axes(param_axes)}
    if compress == "int8_ef":
        state["err"] = param_axes
    return state


def build_eval_step(lm: LM) -> Callable:
    def eval_step(batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return lm.loss(batch)

    return eval_step


def _gathered(named: dict) -> dict:
    """Each DTensor leaf's global tensor (``full_tensor``, a collective
    every rank issues in the same leaf order), plain leaves as they are."""
    from repro_torch.models.shard_ops import whole

    return {n: whole(t) for n, t in O.leaves(named)}


def train_tree(lm: LM, opt_state: dict) -> dict:
    """The training state in the reference's checkpoint layout, in new
    host tensors (a later step does not change it).  Each leaf is copied
    once, straight into its place in the stacked result, so no stacked
    copy is made on the card; a card's layers go to page-locked memory,
    each copy issued without waiting and all waited for once.  On a mesh
    every DTensor leaf is first gathered into its global tensor, on this
    thread, in the reference's leaf order (every rank must run this)."""
    dev = torch.device("cpu")
    pinned = lm.device.type == "cuda"

    def stack(ts: list) -> torch.Tensor:
        if pinned and not ts[0].is_cuda:     # stacks of stacks on the host
            torch.cuda.synchronize(lm.device)
        out = torch.empty((len(ts), *ts[0].shape), dtype=ts[0].dtype,
                          device=dev, pin_memory=pinned)
        for i, t in enumerate(ts):
            out[i].copy_(t, non_blocking=pinned)
        return out

    def joined(named: dict) -> dict:
        return join_tree({n: t.detach() if reference_key(n)[1]
                          else t.detach().to(dev, copy=True)  # not stacked
                          for n, t in _gathered(named).items()}, stack)
    adam = opt_state["adam"]
    opt = {"adam": {"mu": joined(adam["mu"]), "nu": joined(adam["nu"]),
                    "step": adam["step"].detach().to(dev, copy=True)}}
    if "err" in opt_state:
        opt["err"] = joined(opt_state["err"])
    tree = {"params": joined(train_params(lm)), "opt": opt}
    if pinned:
        torch.cuda.synchronize(lm.device)
    return tree


@torch.no_grad()
def load_train_tree(lm: LM, opt_state: dict, tree: dict) -> None:
    """Copy a tree in the reference's checkpoint layout (torch tensors or
    numpy arrays, global leaves: from any mesh or none) into the LM's
    parameters and ``opt_state``, in place; a leaf missing or left over
    raises ``KeyError``.  Into a DTensor each rank copies only its own
    shard's slice of the global leaf (``checkpoint.store.local_slice``),
    which never puts the global leaf on the card: a memory-mapped
    checkpoint is read for that slice alone."""
    from repro_torch.checkpoint.store import local_slice
    from repro_torch.models.sharding import is_dtensor

    cfg = lm.cfg

    def load(dst: dict, sub: dict) -> None:
        src = split_tree(sub, dst, cfg)
        for name, t in dst.items():
            v = src[name]
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
            if tuple(v.shape) != tuple(t.shape) or v.dtype != t.dtype:
                raise ValueError(f"{name}: {v.dtype}{list(v.shape)} does "
                                 f"not fit {t.dtype}{list(t.shape)}")
            if is_dtensor(t):
                t._local_tensor.copy_(local_slice(v, t.device_mesh,
                                                  t.placements))
            else:
                t.copy_(v)

    load(train_params(lm), tree["params"])
    adam, opt = opt_state["adam"], tree["opt"]
    load(adam["mu"], opt["adam"]["mu"])
    load(adam["nu"], opt["adam"]["nu"])
    step = opt["adam"]["step"]
    step = step if isinstance(step, torch.Tensor) else torch.as_tensor(step)
    adam["step"] = step.to(device=adam["step"].device, dtype=torch.int32)
    if set(opt) - {"adam", "err"} or ("err" in opt) != ("err" in opt_state):
        raise KeyError(f"the checkpoint's optimizer state holds "
                       f"{sorted(opt)}, this run's {sorted(opt_state)}")
    if "err" in opt_state:
        load(opt_state["err"], opt["err"])
