"""The model's mesh-aware operations: what the LM does differently when
its tensors are DTensors under a ``sharding.activate(mesh, rules)``
context, each the plain operation on a plain tensor.

DTensor's own strategies either gather what the reference's XLA
partitioning keeps sharded (a vocab-parallel embedding lookup, head and
loss), refuse an in-place write into a tensor sharded along the written
dimension (the caches), or cannot express a loop that is local to each
rank's shard (the attention and SSD chunk loops, the depthwise conv),
or, on the card's torch 2.11, fail (views that split heads over a mesh
axis that does not divide them, ``index_put``'s backward on a table).
These run each rank's part on its local shard and put the DTensor back
together; the gradients of whatever a rank uses for only part of the
work its peers share are summed across them (``local_partial``).
"""

from __future__ import annotations

import functools

import torch

from .sharding import (DEFAULT_RULES, active, is_dtensor, logical_to_spec,
                       placements, suspended)

__all__ = [
    "contiguous_stride", "pin", "write_rows", "write_block",
    "copy_into", "to_layout", "batch_only", "local_window", "take_last",
    "take_rows", "logsumexp_last", "row_chunks", "whole", "local_partial",
    "on_heads", "on_shards", "head_local", "shard_local", "merge_heads",
    "routed_experts",
]


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


class _Pin(torch.autograd.Function):
    """Identity forward; the gradient comes back laid out as the forward
    value was."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.back:
            g = g.redistribute(g.device_mesh, ctx.back)
        return g


def pin(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is laid out as ``x`` itself before it flows
    on (DTensor's backward may pick any layout, and a product's backward
    cannot flatten a batch dim with a sharded sequence beside it); no-op
    off a mesh."""
    if active() is None or not is_dtensor(x) or not x.requires_grad:
        return x
    return _Pin.apply(x)


# --------------------------------------------------------------------------
# In-place writes into sharded caches.  A cache row or block lives on the
# ranks that hold its batch rows and its cache positions; DTensor cannot
# index_put_ into a tensor sharded along the written dimension, so each
# rank writes its own part into its local shard.
# --------------------------------------------------------------------------
def _along(buf_placements, dim: int) -> tuple:
    """Placements of a tensor laid out as ``buf`` but whole along
    ``dim`` (shape otherwise the same)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in buf_placements)


def _without(buf_placements, dim: int) -> tuple:
    """Placements of ``buf`` with its dimension ``dim`` dropped."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for p in buf_placements:
        if isinstance(p, Shard):
            out.append(Replicate() if p.dim == dim else
                       Shard(p.dim - (p.dim > dim)))
        else:
            out.append(p)
    return tuple(out)


def batch_only(buf_placements) -> tuple:
    """Placements of a [B] vector beside ``buf``: sharded where ``buf``'s
    dim 0 is, replicated elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in buf_placements)


def local_window(buf, dim: int) -> tuple[int, int]:
    """(global offset, local length) of this rank's shard of ``buf``
    along ``dim``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        buf.shape, buf.device_mesh, buf.placements)
    return offset[dim], shape[dim]


def write_rows(buf: torch.Tensor, rows: torch.Tensor, at: torch.Tensor,
               new: torch.Tensor) -> None:
    """``buf[rows, at] = new`` in place, ``rows`` every batch row in
    order and ``at`` already within the buffer's dim 1."""
    if not is_dtensor(buf):
        buf[rows, at] = new
        return
    mesh, pl = buf.device_mesh, buf.placements
    new = to_layout(new, mesh, _without(pl, 1)).to_local()
    at = to_layout(at, mesh, batch_only(pl)).to_local()
    off, n = local_window(buf, 1)
    lb = buf.to_local()
    la = at - off
    ok = (la >= 0) & (la < n)
    la = la.clamp(0, n - 1)
    rows = torch.arange(lb.shape[0], device=lb.device)
    mask = ok.reshape((-1,) + (1,) * (new.dim() - 1))
    lb[rows, la] = torch.where(mask, new, lb[rows, la])


def write_block(buf: torch.Tensor, new: torch.Tensor) -> None:
    """``buf[:, :s] = new`` in place, s = ``new.shape[1]``."""
    s = new.shape[1]
    if not is_dtensor(buf):
        buf[:, :s] = new
        return
    new = to_layout(new, buf.device_mesh, _along(buf.placements, 1)).to_local()
    off, n = local_window(buf, 1)
    lo, hi = min(off, s), min(off + n, s)
    if hi > lo:
        buf.to_local()[:, lo - off:hi - off] = new[:, lo:hi]


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, ``src`` first laid out as ``dst``."""
    if is_dtensor(dst):
        src = to_layout(src, dst.device_mesh, tuple(dst.placements))
    dst.copy_(src)


def to_layout(x, mesh, want: tuple):
    """``x`` as a DTensor with placements ``want`` (a plain tensor is
    taken as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != tuple(want):
        x = x.redistribute(mesh, want)
    return x


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i, idx[i]]`` of a [n, V] ``x``: ``torch.gather`` on a plain
    tensor.  On a DTensor sharded along V (a vocab-parallel head) each
    rank gathers the indices that fall in its shard and the result is a
    partial sum over those ranks (DTensor's own strategy for the gather
    fails to reduce its mask in this layout)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[:, None])[:, 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    x = to_layout(x, mesh, pl)
    rows = batch_only(pl)
    idx = to_layout(idx, mesh, rows).to_local()
    off, n = local_window(x, 1)
    li = idx - off
    ok = (li >= 0) & (li < n)
    g = torch.gather(x.to_local(), -1, li.clamp(0, n - 1)[:, None])[:, 0]
    g = torch.where(ok, g, torch.zeros_like(g))
    out_pl = [Partial() if isinstance(p, Shard) and p.dim == 1 else r
              for p, r in zip(pl, rows)]
    return DTensor.from_local(g, mesh, out_pl, run_check=False,
                              shape=torch.Size(x.shape[:1]), stride=(1,))


def whole(x: torch.Tensor) -> torch.Tensor:
    """The global tensor on every rank (``full_tensor``) of a DTensor; a
    plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``.  On a DTensor table sharded along its rows (a
    vocab-parallel embedding) each rank looks up the indices that fall in
    its shard and the result is a partial sum over those ranks, where
    DTensor's own strategy gathers the whole table first.  A table
    sharded along its columns (FSDP) is gathered along them first; one
    whole along its rows serves each rank's own tokens the same way
    (DTensor's backward of ``table[idx]`` fails there on torch 2.11)."""
    if not is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim != 0 else p
               for p in table.placements)
    vocab = [isinstance(p, Shard) for p in pl]
    table = to_layout(table, mesh, pl)
    idx = to_layout(idx, mesh, tuple(
        Replicate() if v else q for v, q in zip(vocab, idx.placements)
    ) if is_dtensor(idx) else tuple(Replicate() for _ in pl))
    off, n = local_window(table, 0)
    li = idx.to_local() - off
    ok = (li >= 0) & (li < n)
    # a rank's rows of the table serve only its own tokens
    t = table.to_local(grad_placements=[
        Shard(0) if v else Partial() if isinstance(q, Shard) else Replicate()
        for v, q in zip(vocab, idx.placements)])
    g = t[li.clamp(0, n - 1)]
    g = torch.where(ok[..., None], g, torch.zeros_like(g))
    shape = tuple(idx.shape) + tuple(table.shape[1:])
    return DTensor.from_local(
        g, mesh, [Partial() if v else q for v, q in zip(vocab, idx.placements)],
        run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1)``.  On a DTensor sharded along its last
    dimension (vocab-parallel logits) the max and the sum are reduced
    across the shards (the max taken as a constant, which leaves the
    gradient exact), where DTensor's own strategy gathers the whole
    dimension first."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import DTensor, Partial, Shard

    last = x.dim() - 1
    if not any(isinstance(p, Shard) and p.dim == last for p in x.placements):
        return torch.logsumexp(x, dim=-1)
    mesh = x.device_mesh
    pl = tuple(_replicate() if p.is_partial() else p for p in x.placements)
    x = to_layout(x, mesh, pl)
    red = [Partial("max") if isinstance(p, Shard) and p.dim == last else p
           for p in pl]
    shape = torch.Size(x.shape[:-1])
    stride = contiguous_stride(shape)
    m = DTensor.from_local(x.to_local().detach().amax(dim=-1), mesh, red,
                           run_check=False, shape=shape, stride=stride)
    m = m.redistribute(mesh, [_unshard(p, last) for p in pl])
    e = torch.exp(x.to_local() - m.to_local()[..., None]).sum(dim=-1)
    s = DTensor.from_local(e, mesh, [Partial() if isinstance(p, Shard)
                                     and p.dim == last else p for p in pl],
                           run_check=False, shape=shape, stride=stride)
    s = s.redistribute(mesh, [_unshard(p, last) for p in pl])
    return m + torch.log(s)


def _unshard(p, dim: int):
    """``Replicate()`` for a ``Shard(dim)`` placement, else ``p``."""
    from torch.distributed.tensor import Replicate, Shard

    return Replicate() if isinstance(p, Shard) and p.dim == dim else p


def row_chunks(x: torch.Tensor, y: torch.Tensor, chunk: int, n: int):
    """``(x[c*chunk:(c+1)*chunk], y[...])`` for c < n.  On DTensors
    sharded along their rows, chunk c is each rank's own c-th share of
    ``chunk // shards`` local rows (slicing the global rows would gather
    them): the same rows in another order when ``n * chunk`` covers every
    row, and on one rank the same chunks."""
    shards = 1
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor, Shard

        rows = [isinstance(p, Shard) and p.dim == 0 for p in x.placements]
        for size, r in zip(x.device_mesh.shape, rows):
            shards *= size if r else 1
    if shards == 1 or chunk % shards:
        for c in range(n):
            yield x[c * chunk:(c + 1) * chunk], y[c * chunk:(c + 1) * chunk]
        return
    mesh = x.device_mesh
    y = to_layout(y, mesh, tuple(p if r else _replicate() for p, r in
                                 zip(x.placements, rows)))
    xl, yl = x.to_local(), y.to_local()
    lc = chunk // shards
    for c in range(n):
        xs = xl[c * lc:(c + 1) * lc]
        ys = yl[c * lc:(c + 1) * lc]
        xshape = (chunk,) + tuple(x.shape[1:])
        yield (DTensor.from_local(xs, mesh, x.placements, run_check=False,
                                  shape=torch.Size(xshape),
                                  stride=contiguous_stride(xshape)),
               DTensor.from_local(ys, mesh, y.placements, run_check=False,
                                  shape=torch.Size((chunk,)), stride=(1,)))


def _replicate():
    from torch.distributed.tensor import Replicate

    return Replicate()


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over mesh dims
    (Megatron's copy-to-parallel-region)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        for d in ctx.dims:
            g = funcol.all_reduce(g.contiguous(), "sum", (ctx.mesh, d))
        return g, None, None


def local_partial(x, over) -> torch.Tensor:
    """``x.to_local()`` for a rank that uses its shard for only part of
    the work its peers along the mesh dims ``over`` (a list of bools)
    share: their gradients are summed across those dims."""
    dims = [d for d, o in enumerate(over) if o]
    loc = x.to_local()
    if not dims or not torch.is_grad_enabled() or not loc.requires_grad:
        return loc
    return _SumGrads.apply(loc, x.device_mesh, dims)


def on_heads(fn, q, k, v):
    """``fn(q, k, v)`` run by each rank on its own shard, with no context
    active inside: q [B, S, H, *], k and v [B, T, G, *] laid out over the
    batch axes and, when the G kv heads divide over it, the model axis
    (each rank then holds whole groups of query heads: the reference's
    ``kv_heads`` hint).  The result is laid out as q."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = q.device_mesh
    ctx = active()
    rules = ctx[1] if ctx is not None else DEFAULT_RULES
    b, g = k.shape[0], k.shape[2]
    spec = logical_to_spec(mesh, ("batch", None, "kv_heads"),
                           (b, k.shape[1], g), rules)
    pl = placements(mesh, spec)
    q, k, v = (to_layout(t, mesh, pl) for t in (q, k, v))
    with suspended():
        out = fn(q.to_local(), k.to_local(), v.to_local()).contiguous()
    shape = tuple(q.shape[:3]) + tuple(out.shape[3:])
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def on_shards(fn, args, axes, outs):
    """``fn(*args)`` run by each rank on its own shards, with no context
    active inside: each of ``args`` laid out by its logical axes in
    ``axes`` (``None``: not a tensor, passed as it is), each output by its
    ``(logical axes, global shape)`` in ``outs`` (a list, one an output).
    An argument whole on a mesh dim that splits another argument (B and C
    of a head-parallel scan) takes gradients summed over that dim."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    ctx = active()
    rules = ctx[1] if ctx is not None else DEFAULT_RULES
    pls = [None if ax is None else
           placements(mesh, logical_to_spec(mesh, ax, tuple(a.shape), rules))
           for a, ax in zip(args, axes)]
    split = [any(isinstance(pl[d], Shard) for pl in pls if pl)
             for d in range(mesh.ndim)]
    locs = []
    for a, pl in zip(args, pls):
        if pl is None:
            locs.append(a)
            continue
        a = to_layout(a, mesh, pl)
        locs.append(local_partial(a, [s and not isinstance(p, Shard)
                                      for s, p in zip(split, pl)]))
    with suspended():
        got = fn(*locs)
    single = not isinstance(got, tuple)
    got = (got,) if single else got
    res = []
    for o, (ax, shape) in zip(got, outs):
        spec = logical_to_spec(mesh, ax, shape, rules)
        res.append(DTensor.from_local(
            o.contiguous(), mesh, placements(mesh, spec), run_check=False,
            shape=torch.Size(shape), stride=contiguous_stride(shape)))
    return res[0] if single else tuple(res)


def head_local(fn):
    """An attention core ``fn(q, k, v, **kw)``, itself on plain tensors;
    on DTensors run by each rank on its own shard (:func:`on_heads`)."""
    @functools.wraps(fn)
    def run(q, k, v, **kw):
        if not is_dtensor(q):
            return fn(q, k, v, **kw)
        return on_heads(functools.partial(fn, **kw), q, k, v)
    return run


def shard_local(layout):
    """``fn(*args, **kw)`` itself on plain tensors; on DTensors run by
    each rank on its own shards (:func:`on_shards`), laid out by
    ``layout(*args, **kw)`` -> (each argument's logical axes, each
    output's ``(logical axes, global shape)``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            if not is_dtensor(args[0]):
                return fn(*args, **kw)
            axes, outs = layout(*args, **kw)
            return on_shards(functools.partial(fn, **kw), args, axes, outs)
        return run
    return wrap


def routed_experts(p, xt, gate, flat_e, slot, keep, cap: int, k: int, dt, *,
                   slot_in, ffn, combine):
    """The routed experts' output [n, d] of tokens ``xt`` [n, d]:
    ``combine(ffn(slot_in(...)))``, the MoE's own pieces, on plain
    tensors.

    On DTensors (tokens sharded over the data axes, experts over the
    model axis) each rank slots its own tokens' replicas that go to its
    own experts into a [local experts, cap, d] buffer at their global
    slots; summed over the token shards (a reduce-scatter along ``cap``)
    that is the global buffer, so the capacity drops are the single-
    device ones.  The FFNs run on each rank's slots of its experts, the
    outputs come back along ``cap`` (an all-gather), and each rank's token
    outputs from its own experts are a partial sum over the expert
    shards.  With several expert shards a token's k choices add in the
    all-reduce's order, not in choice order, so bf16 outputs may differ in
    their last bit."""
    e = p["w_gate"].shape[0]
    if not is_dtensor(xt):
        out = ffn(p, dt, slot_in(xt, flat_e, slot, keep, e, cap, k, dt))
        return combine(out, gate, flat_e, slot, keep, cap, xt.shape[0], k, dt)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    n, d = xt.shape
    mesh = xt.device_mesh
    xt = to_layout(xt, mesh, batch_only(xt.placements))
    gate = to_layout(gate, mesh, tuple(xt.placements))
    tok_dims = [isinstance(q, Shard) for q in xt.placements]
    exp_dims = [isinstance(q, Shard) and q.dim == 0
                for q in p["w_gate"].placements]
    t0, m = local_window(xt, 0)
    e0, en = local_window(p["w_gate"], 0)

    def layout(on_tokens, on_experts):
        return [on_tokens if t else on_experts if x else Replicate()
                for t, x in zip(tok_dims, exp_dims)]

    # a rank's tokens and gates feed only its own experts: their
    # gradients are summed over the expert shards
    xl = local_partial(xt, exp_dims)
    gate = local_partial(gate, exp_dims)
    mine = slice(t0 * k, (t0 + m) * k)
    fe, sl, kp = flat_e[mine], slot[mine], keep[mine]
    here = (fe >= e0) & (fe < e0 + en)
    le = torch.where(here, fe - e0, 0)
    kp = kp & here
    local_in = slot_in(xl, le, sl, kp, en, cap, k, dt)

    expert_in = DTensor.from_local(
        local_in, mesh, layout(Partial(), Shard(0)), run_check=False,
        shape=torch.Size((e, cap, d)), stride=(cap * d, d, 1))
    # the slots split over the token shards when they divide evenly (a
    # decode step's few slots are summed whole instead)
    n_tok = 1
    for size, t in zip(mesh.shape, tok_dims):
        n_tok *= size if t else 1
    expert_in = expert_in.redistribute(mesh, layout(
        Shard(1) if cap % n_tok == 0 else Replicate(), Shard(0)))
    out = ffn(p, dt, expert_in)
    out = to_layout(out, mesh, tuple(layout(Replicate(), Shard(0))))
    # ... and a rank reads the outputs of its own tokens' slots only
    out = local_partial(out, tok_dims)
    y = combine(out, gate, le, sl, kp, cap, m, k, dt)
    return DTensor.from_local(y, mesh, layout(Shard(0), Partial()),
                              run_check=False, shape=torch.Size((n, d)),
                              stride=(d, 1))


def merge_heads(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, w)``, an attention's output
    projection.  On DTensors each rank contracts its own batch rows' heads
    with its own heads' rows of ``w`` (whole along d), and the result is a
    partial sum over the heads' shards: DTensor's own backward views the
    fused H*K gradient columns back into heads, which fails on torch 2.11
    where its strategy splits them over a mesh axis that does not divide
    H."""
    if not is_dtensor(out):
        return torch.einsum("bshk,hkd->bsd", out, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = out.device_mesh
    ctx = active()
    rules = ctx[1] if ctx is not None else DEFAULT_RULES
    b, s, h, _ = out.shape
    pl_out = placements(mesh, logical_to_spec(
        mesh, ("batch", None, "heads"), (b, s, h), rules))
    pl_w = placements(mesh, logical_to_spec(mesh, ("heads",), (h,), rules))
    out, w = to_layout(out, mesh, pl_out), to_layout(w, mesh, pl_w)
    heads = [isinstance(p, Shard) for p in pl_w]
    rows = [isinstance(p, Shard) and p.dim == 0 for p in pl_out]
    # w serves only this rank's rows: its gradients summed over their shards
    wl = local_partial(w, [r and not hd for r, hd in zip(rows, heads)])
    y = torch.einsum("bshk,hkd->bsd", out.to_local(), wl)
    shape = (b, s, w.shape[-1])
    return DTensor.from_local(
        y, mesh, [Partial() if hd else Shard(0) if r else Replicate()
                  for hd, r in zip(heads, rows)],
        run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))
