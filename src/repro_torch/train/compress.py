"""Int8 error-feedback gradient compression.

The port of ``repro.train.compress`` (the 1-bit-Adam / EF-SGD family):
each gradient is quantized to int8 with a per-tensor scale, and the
quantization residual is carried in a float32 error-feedback buffer so
the compression bias telescopes away over steps.  The round trip and its
buffers are what ``build_train_step(compress="int8_ef")`` runs and the
tests hold to the reference.  On a mesh the buffers are DTensors placed
like their parameters and each leaf's scale is the max over all its
shards; DTensor has already reduced the gradients in the backward pass,
so, as in the reference's compiled step, the round trip shrinks no
collective (``launch.perfvariants`` carries the payload analytically).
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

from repro_torch.models.convert import reference_key
from repro_torch.models.shard_ops import like, whole

from .optimizer import leaves, zeros_like_param

__all__ = ["init_error_buffers", "compress_decompress"]


def init_error_buffers(params: Mapping) -> dict:
    return {n: zeros_like_param(p, torch.float32)
            for n, p in leaves(params)}


def _quantize(x: torch.Tensor, scale: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes round half to even, clipped to +-127; the scale is per tensor,
    max|x| / 127, unless one is given."""
    if scale is None:
        scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_decompress(grads: Mapping, err: Mapping
                        ) -> tuple[dict, dict, dict]:
    """Error-feedback int8 round trip: g' = Q(g + e); e' = (g + e) - g'.

    The scale is per tensor of the reference's tree: a stacked leaf's
    layers (``layers.{i}.ssm.w_in`` for every i) share one, the max over
    all of them and, on a mesh, over every shard of each.  Returns (new
    grads in the gradients' dtype, ``err`` overwritten in place with e',
    {"compress_rel_err": |e'| / |g|})."""
    new_g = {}
    for members in _by_reference_leaf(grads):
        # each gradient laid out as its buffer; a leaf's max over every
        # shard of every layer
        members = [(n, like(g, err[n])) for n, g in members]
        amax = torch.stack([whole(torch.max(torch.abs(
            g.to(torch.float32) + err[n]))) for n, g in members]).max()
        scale = torch.clamp(amax, min=1e-12) / 127.0
        for name, g in members:
            gf = g.to(torch.float32) + err[name]
            q, _ = _quantize(gf, scale)
            deq = q.to(torch.float32) * scale
            new_g[name] = deq.to(g.dtype)
            err[name].copy_(gf - deq)
    num = den = None
    for name, g in leaves(grads):
        e2 = torch.sum(torch.square(err[name]))
        g2 = torch.sum(torch.square(g.to(torch.float32)))
        num = e2 if num is None else num + e2
        den = g2 if den is None else den + g2
    rel = torch.sqrt(num / torch.clamp(den, min=1e-12))
    return new_g, err, {"compress_rel_err": rel}


def _by_reference_leaf(tree: Mapping) -> list[list[tuple[str, torch.Tensor]]]:
    """The tree's (name, tensor) grouped by the reference's leaf each
    belongs to, in its leaf order."""
    groups: dict[str, list] = {}
    for name, t in leaves(tree):
        groups.setdefault(reference_key(name)[0], []).append((name, t))
    return list(groups.values())
