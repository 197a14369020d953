"""The arithmetic of the flash kernels (``csrc/flash_attention.cu``)
emulated in PyTorch on the CPU, at every head width D % 8 == 0 up to 1024
(512 in bf16).

Both kernels run at the padded width ``DP = plan.padded_head_dim(D)``: the
emulations pad q, k and v with zero columns up to DP, as the kernels' shared
memory holds them (TMA's zero fill for ``flash_fwd_sm90``, the zeroed places
of ``flash_fwd_kernel``'s rows), walk the tiles ``plan`` gives DP, take the
scale from the real D and keep the output's first D columns.

- :func:`sm90_emulation`: ``flash_fwd_sm90`` (bf16) on 128-row q tiles and
  ``plan.sm90_kv_rows(DP)`` kv rows: S = Q K^T in f32 from bf16 inputs, the
  online softmax in the log2 domain with ``scale * log2(e)`` folded into
  one multiply of the dot, scores masked to -1e30 on the tile that crosses
  the diagonal and kv tiles above it skipped, P split into two bf16
  halves (``hi = bf16(p)``, ``lo = bf16(p - hi)``) both multiplied by bf16
  V into an f32 accumulator, ``out = acc / max(l, 1e-30)`` rounded to bf16.
- :func:`kernel_emulation`: ``flash_fwd_kernel`` + ``flash_combine`` (f32):
  each range of kv rows runs the online softmax over its own chunks
  (``plan.f32_tiles(DP)``), a row's sum kept as 16 lanes' shares added at
  the end; the combine folds the ranges in order.
- Above D = 256 the wide kernels, which deal the head's 64-column panels
  to blocks along the grid's z (``plan.wide_panels``), each writing its
  own columns of O: :func:`wide_kernel_emulation` (``flash_fwd_wide`` +
  ``flash_combine``, a thread-block cluster: each kv step each rank's
  partial S_r over its own columns of Q and K (``plan.wide_s_panels``),
  summed S_0 + S_1 + ... in rank order (:func:`cluster_scores`), then the
  online softmax and P V per rank into its columns of O;
  ``plan.wide_f32_plan``'s 64-row q tiles and 32-row kv steps, the split's
  partials per range, (m, l) from rank 0) and :func:`wide_sm90_emulation`
  (``flash_fwd_wide_sm90``: each block S over the whole head, summed over
  its 64-column panels in order (:func:`panel_scores`), 128-row q tiles,
  64-row kv tiles, P split as above).

Every emulation takes any Sq, Sk >= 1, as the kernels do: the last q tile
and the last kv tile may be partial, their rows past the end zeros
(:func:`pad_seq`, as TMA's zero fill and the zero-filling copies put
them), the scores of kv rows past Sk masked to -1e30 like those above the
diagonal (:func:`keep_mask`), and the output's rows past Sq dropped.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.plan import (PANEL, f32_tiles,
                                                      padded_head_dim,
                                                      sm90_kv_rows,
                                                      wide_f32_plan,
                                                      wide_panels,
                                                      wide_s_panels,
                                                      wide_sm90_plan)

__all__ = ["sm90_emulation", "kernel_emulation", "split_partials",
           "wide_sm90_emulation", "wide_kernel_emulation", "cluster_scores",
           "panel_scores", "rank_columns", "pad_head", "pad_seq", "keep_mask",
           "NEG_INF", "LANES", "SM90_BLOCK"]

NEG_INF = -1e30
LANES = 16        # f32: lanes that share one score row
SM90_BLOCK = 128  # bf16: q rows a block holds


def pad_head(x: torch.Tensor) -> torch.Tensor:
    """x [..., D] with zero columns up to DP = ``padded_head_dim(D)``."""
    d = x.shape[-1]
    return F.pad(x, (0, padded_head_dim(d) - d))


def pad_seq(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x [B, S, heads, D] with zero rows up to a whole number of ``rows``
    tiles: a partial tile's rows past S, as the kernels load them."""
    s = x.shape[1]
    return F.pad(x, (0, 0, 0, 0, 0, -(-s // rows) * rows - s))


def keep_mask(q0: int, n_q: int, k0: int, n_k: int, sk: int,
              causal: bool) -> torch.Tensor | None:
    """The scores a kernel keeps in the [n_q, n_k] tile at (q0, k0): those
    on or below the diagonal when causal, and of kv rows below Sk; None
    where the tile keeps all (neither the diagonal nor Sk crosses it)."""
    diag = causal and k0 + n_k - 1 > q0
    if not diag and k0 + n_k <= sk:
        return None
    kpos = (k0 + torch.arange(n_k))[None, :]
    keep = kpos < sk
    if diag:
        keep = keep & ((q0 + torch.arange(n_q))[:, None] >= kpos)
    return keep


def _masked(s: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
    return s if keep is None else torch.where(keep, s, torch.tensor(NEG_INF))


def _scale_log2(d: int) -> float:
    return d ** -0.5 * math.log2(math.e)


def sm90_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, split_p: bool = True) -> torch.Tensor:
    """flash_fwd_sm90's arithmetic on bf16 q [B, Sq, H, D] and k, v
    [B, Sk, G, D] -> bf16 [B, Sq, H, D]; ``split_p=False`` rounds P once
    to bf16 instead of splitting it."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    rep = h // g
    scale_log2 = _scale_log2(d)
    q, k, v = (pad_head(x) for x in (q, k, v))
    dp = q.shape[-1]
    bk = sm90_kv_rows(dp)         # 128, or 64 at DP 192 and 256
    q = pad_seq(q, SM90_BLOCK)
    k, v = pad_seq(k, bk), pad_seq(v, bk)
    out = torch.empty(b, q.shape[1], h, dp, dtype=torch.bfloat16)
    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, sq, SM90_BLOCK):
                qt = q[bi, q0:q0 + SM90_BLOCK, hi].float()
                m = torch.full((SM90_BLOCK, 1), NEG_INF)
                l = torch.zeros(SM90_BLOCK, 1)
                acc = torch.zeros(SM90_BLOCK, dp)
                for k0 in range(0, sk, bk):
                    if causal and k0 > q0 + SM90_BLOCK - 1:
                        break
                    kt = k[bi, k0:k0 + bk, hi // rep].float()
                    vt = v[bi, k0:k0 + bk, hi // rep].float()
                    s = _masked((qt @ kt.T) * scale_log2,
                                keep_mask(q0, SM90_BLOCK, k0, bk, sk, causal))
                    m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new)
                    l = l * alpha + p.sum(dim=1, keepdim=True)
                    p_hi = p.to(torch.bfloat16).float()
                    pv = p_hi @ vt
                    if split_p:
                        pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vt
                    acc = acc * alpha + pv
                    m = m_new
                out[bi, q0:q0 + SM90_BLOCK, hi] = (
                    acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)
    return out[:, :sq, :, :d].contiguous()


def _range(q0: int, kv0: int, per: int, sk: int, causal: bool,
           dp: int) -> range:
    """The chunk starts one f32 block walks: kv rows [kv0, kv0 + per), cut
    at the end of the q tile's diagonal when causal."""
    block_q, chunk = f32_tiles(dp)
    kv1 = min(sk, kv0 + per)
    if causal:
        kv1 = min(kv1, q0 + block_q)
    return range(kv0, max(kv0, kv1), chunk)


def split_partials(qt, kt, vt, q0: int, kv0: int, per: int, sk: int,
                   causal: bool, *, d: int | None = None):
    """One f32 block's (m, l, acc) for a [block_q, DP] q tile
    (``plan.f32_tiles``: 128 rows, 64 above DP = 128) against kv rows
    [kv0, kv0 + per) of one head, all padded to DP: m in the log2 domain
    at the scale of the real head width ``d`` (by default DP), l the 16
    lanes' shares (4 columns each, 2 above DP = 128) added at the end.  kt
    and vt hold whole chunks, their rows past ``sk`` zeros."""
    block_q, dp = qt.shape
    chunk = f32_tiles(dp)[1]
    scale_log2 = _scale_log2(d or dp)
    m = torch.full((block_q, 1), NEG_INF)
    l_lane = torch.zeros(block_q, LANES)
    acc = torch.zeros(block_q, dp)
    for k0 in _range(q0, kv0, per, sk, causal, dp):
        s = _masked((qt @ kt[k0:k0 + chunk].T) * scale_log2,
                    keep_mask(q0, block_q, k0, chunk, sk, causal))
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        quad = p.reshape(block_q, LANES, chunk // LANES)
        if quad.shape[-1] == 4:
            share = (quad[..., 0] + quad[..., 1]) + (quad[..., 2]
                                                     + quad[..., 3])
        else:
            share = quad[..., 0] + quad[..., 1]
        l_lane = l_lane * alpha + share
        acc = acc * alpha + p @ vt[k0:k0 + chunk]
        m = m_new
    while l_lane.shape[1] > 1:                        # xor 1, 2, 4, 8
        l_lane = l_lane[:, 0::2] + l_lane[:, 1::2]
    return m, l_lane, acc


def kernel_emulation(q, k, v, *, causal: bool, per: int) -> torch.Tensor:
    """flash_fwd_kernel (+ flash_combine when ``per`` < Sk) on f32 q
    [B, Sq, H, D] and k, v [B, Sk, G, D]."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    rep = h // g
    q, k, v = (pad_head(x) for x in (q, k, v))
    dp = q.shape[-1]
    block_q, chunk = f32_tiles(dp)
    q = pad_seq(q, block_q)
    k, v = pad_seq(k, chunk), pad_seq(v, chunk)
    out = torch.empty(b, q.shape[1], h, dp)
    for bi in range(b):
        for hi in range(h):
            kt, vt = k[bi, :, hi // rep], v[bi, :, hi // rep]
            for q0 in range(0, sq, block_q):
                qt = q[bi, q0:q0 + block_q, hi]
                parts = [split_partials(qt, kt, vt, q0, kv0, per, sk, causal,
                                        d=d)
                         for kv0 in range(0, sk, per)]
                if len(parts) == 1:
                    _, l, acc = parts[0]
                    out[bi, q0:q0 + block_q, hi] = acc / torch.clamp(
                        l, min=1e-30)
                    continue
                big_m = parts[0][0]
                for m, _, _ in parts[1:]:
                    big_m = torch.maximum(big_m, m)
                big_l = torch.zeros_like(big_m)
                o = torch.zeros(block_q, dp)
                for m, l, acc in parts:        # in range order
                    w = torch.exp2(m - big_m)
                    big_l = big_l + l * w
                    o = o + acc * w
                out[bi, q0:q0 + block_q, hi] = o / torch.clamp(big_l,
                                                               min=1e-30)
    return out[:, :sq, :, :d].contiguous()


def rank_columns(dp: int, runs=wide_panels) -> list[slice]:
    """The columns of the head each of a wide kernel's blocks along z
    holds at padded width ``dp``, in rank order: of O and V
    (``plan.wide_panels``), or of Q and K with ``runs=wide_s_panels``."""
    return [slice(PANEL * p0, PANEL * (p0 + n)) for p0, n in runs(dp)]


def cluster_scores(qt: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """S = Q K^T for a q tile and a kv tile padded to DP as flash_fwd_wide's
    cluster forms it: each rank's partial over its own columns of Q and K
    (``plan.wide_s_panels``), the partials added in rank order (S_0 + S_1
    + ...), as every rank does, so each holds the same S."""
    cols = rank_columns(qt.shape[1], wide_s_panels)
    s = qt[:, cols[0]] @ kt[:, cols[0]].T
    for c in cols[1:]:
        s = s + qt[:, c] @ kt[:, c].T
    return s


def panel_scores(qt: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """S = Q K^T for a q tile and a kv tile padded to DP, summed over the
    64-column panels of both in order, as each flash_fwd_wide_sm90 block
    streams K."""
    s = qt[:, :PANEL] @ kt[:, :PANEL].T
    for c0 in range(PANEL, qt.shape[1], PANEL):
        s = s + qt[:, c0:c0 + PANEL] @ kt[:, c0:c0 + PANEL].T
    return s


def wide_sm90_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool) -> torch.Tensor:
    """flash_fwd_wide_sm90's arithmetic on bf16 q [B, Sq, H, D] and k, v
    [B, Sk, G, D] (256 < D <= 512) -> bf16 [B, Sq, H, D]: each block S
    over the whole head (the same in both), then its P V into its own
    columns (those past D zeros in V)."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    rep = h // g
    scale_log2 = _scale_log2(d)
    q, k, v = (pad_head(x) for x in (q, k, v))
    dp = q.shape[-1]
    plan = wide_sm90_plan(dp)
    bq, bk = plan.block_q, plan.kv_rows
    cols = rank_columns(dp)
    q = pad_seq(q, bq)
    k, v = pad_seq(k, bk), pad_seq(v, bk)
    out = torch.empty(b, q.shape[1], h, dp, dtype=torch.bfloat16)
    for bi, hi, q0 in itertools.product(range(b), range(h),
                                        range(0, sq, bq)):
        qt = q[bi, q0:q0 + bq, hi].float()
        m = torch.full((bq, 1), NEG_INF)
        l = torch.zeros(bq, 1)
        accs = [torch.zeros(bq, c.stop - c.start) for c in cols]
        for k0 in range(0, sk, bk):
            if causal and k0 > q0 + bq - 1:
                break
            kt = k[bi, k0:k0 + bk, hi // rep].float()
            vt = v[bi, k0:k0 + bk, hi // rep].float()
            s = _masked(panel_scores(qt, kt) * scale_log2,
                        keep_mask(q0, bq, k0, bk, sk, causal))
            m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(dim=1, keepdim=True)
            p_hi = p.to(torch.bfloat16).float()
            p_lo = (p - p_hi).to(torch.bfloat16).float()
            accs = [acc * alpha + (p_hi @ vt[:, c] + p_lo @ vt[:, c])
                    for acc, c in zip(accs, cols)]
            m = m_new
        for acc, c in zip(accs, cols):
            out[bi, q0:q0 + bq, hi, c] = (
                acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)
    return out[:, :sq, :, :d].contiguous()


def wide_partials(qt, kt, vt, q0: int, kv0: int, per: int, sk: int,
                  causal: bool, *, d: int):
    """One flash_fwd_wide cluster's (m, l, acc) for a [64, DP] q tile
    against kv rows [kv0, kv0 + per): S from the ranks' partials
    (:func:`cluster_scores`), l as 16 lanes' shares of 2 columns each,
    added at the end, and each rank's acc over its own columns of V, laid
    side by side."""
    block_q, dp = qt.shape
    chunk = wide_f32_plan(dp).kv_rows
    scale_log2 = _scale_log2(d)
    cols = rank_columns(dp)
    m = torch.full((block_q, 1), NEG_INF)
    l_lane = torch.zeros(block_q, LANES)
    accs = [torch.zeros(block_q, c.stop - c.start) for c in cols]
    kv1 = min(sk, kv0 + per)
    if causal:
        kv1 = min(kv1, q0 + block_q)
    for k0 in range(kv0, max(kv0, kv1), chunk):
        s = _masked(cluster_scores(qt, kt[k0:k0 + chunk]) * scale_log2,
                    keep_mask(q0, block_q, k0, chunk, sk, causal))
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        pair = p.reshape(block_q, LANES, chunk // LANES)
        l_lane = l_lane * alpha + (pair[..., 0] + pair[..., 1])
        accs = [acc * alpha + p @ vt[k0:k0 + chunk, c]
                for acc, c in zip(accs, cols)]
        m = m_new
    while l_lane.shape[1] > 1:                        # xor 1, 2, 4, 8
        l_lane = l_lane[:, 0::2] + l_lane[:, 1::2]
    return m, l_lane, torch.cat(accs, dim=1)


def wide_kernel_emulation(q, k, v, *, causal: bool,
                          per: int) -> torch.Tensor:
    """flash_fwd_wide (+ flash_combine when ``per`` < Sk) on f32 q
    [B, Sq, H, D] and k, v [B, Sk, G, D] (256 < D <= 1024): each cluster
    one (q tile, kv range) of ``plan.wide_f32_plan(DP)``, S summed from the
    ranks' partials; the ranges' partials folded in order with rank 0's
    (m, l)."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    rep = h // g
    q, k, v = (pad_head(x) for x in (q, k, v))
    dp = q.shape[-1]
    block_q, chunk = wide_f32_plan(dp)[:2]
    q = pad_seq(q, block_q)
    k, v = pad_seq(k, chunk), pad_seq(v, chunk)
    out = torch.empty(b, q.shape[1], h, dp)
    for bi, hi, q0 in itertools.product(range(b), range(h),
                                        range(0, sq, block_q)):
        kt, vt = k[bi, :, hi // rep], v[bi, :, hi // rep]
        qt = q[bi, q0:q0 + block_q, hi]
        parts = [wide_partials(qt, kt, vt, q0, kv0, per, sk, causal, d=d)
                 for kv0 in range(0, sk, per)]
        if len(parts) == 1:
            _, l, acc = parts[0]
            o = acc / torch.clamp(l, min=1e-30)
        else:
            big_m = parts[0][0]
            for m, _, _ in parts[1:]:
                big_m = torch.maximum(big_m, m)
            big_l = torch.zeros_like(big_m)
            o = torch.zeros_like(parts[0][2])
            for m, l, acc in parts:        # in range order
                w = torch.exp2(m - big_m)
                big_l = big_l + l * w
                o = o + acc * w
            o = o / torch.clamp(big_l, min=1e-30)
        out[bi, q0:q0 + block_q, hi] = o
    return out[:, :sq, :, :d].contiguous()
