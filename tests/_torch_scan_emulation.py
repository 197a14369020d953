"""The arithmetic of the kernels at the shapes beyond the reference's
kernel route, emulated on the CPU in numpy float32:

- ``chunked_split_emulation``: ``ssm_chunked_general``
  (``csrc/ssm_chunked_scan.cu``) at its plan (``plan.scan_plan``) for any
  D and N: channel tiles of ``channels`` (the last partial, its channels
  past D never stored), the state's N rows in ``parts`` of ``per`` rows,
  each padded with zero rows of b and c to ``state_rows``; a thread's R
  rows op by op, its part of y four fused multiply-add chains added
  pairwise, the row groups' parts four running sums added pairwise; with
  more than one part each part's y in float32, added in part order
  (``ssm_chunked_combine``).
- ``ema_walk_emulation``: ``ssm_ema_kernel`` (``csrc/ssm_ema_scan.cu``)
  at ``plan.ema_plan`` for any D: ``ceil(D / CH)`` blocks, the last one's
  channels past D idle, each channel walking time in order.
- ``moe_tiled_emulation``: ``moe_gemm_f32`` at any D and F: the K axis in
  stages of ``K_STAGE`` columns, the last zero-filled past D, the N axis in
  tiles of ``N_TILE`` columns, the last one's columns past F never stored.
"""

import numpy as np

from repro_torch.kernels.ssm_scan.plan import (ema_plan, scan_plan,
                                               state_split)

H100_SMS = 132
K_STAGE = 32     # moe_gemm_f32's kBK
N_TILE = 128     # moe_gemm_f32's kBN


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """fmaf in float32: the product exact in float64, one rounding of the
    sum (to float64, then float32; both to nearest)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _part_y(x, dt, b, c, rows: int, np_: int):
    """One part's y [T, D] (float32) and state after every step
    [T, np_, D], its b and c padded with zero rows to ``np_``."""
    t_len, d = x.shape
    pad = np_ - b.shape[1]
    b = np.pad(b, ((0, 0), (0, pad)))
    c = np.pad(c, ((0, 0), (0, pad)))
    groups = np_ // rows
    h = np.zeros((np_, d), dtype=np.float32)
    y = np.empty((t_len, d), dtype=np.float32)
    states = np.empty((t_len, np_, d), dtype=np.float32)
    for t in range(t_len):
        h = (dt[t][None, :] * h) + (b[t][:, None] * x[t][None, :])
        states[t] = h
        acc = np.zeros((groups, 4, d), dtype=np.float32)
        for j in range(rows):
            rows_j = np.arange(groups) * rows + j
            acc[:, j % 4] = _fma(c[t, rows_j][:, None], h[rows_j],
                                 acc[:, j % 4])
        part = (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])
        sums = np.zeros((4, d), dtype=np.float32)
        for g in range(groups):
            sums[g % 4] = sums[g % 4] + part[g]
        y[t] = (sums[0] + sums[1]) + (sums[2] + sums[3])
    return y, states


def chunked_split_emulation(x, dt, b, c, *, itemsize: int = 4):
    """y [T, D] and the state after every step [T, N, D] of the chunked
    kernel at this card's plan, in float32."""
    t_len, d = x.shape
    n = b.shape[1]
    plan = scan_plan(t_len, d, n, itemsize, n_sm=H100_SMS)
    parts, per, np_ = state_split(n)
    assert (plan.parts, plan.state_rows) == (parts, np_)
    ys, states = [], []
    for p in range(parts):
        cols = slice(p * per, min(n, (p + 1) * per))
        y, st = _part_y(x, dt, b[:, cols], c[:, cols], plan.rows, np_)
        ys.append(y)
        states.append(st[:, :cols.stop - cols.start])
    y = ys[0]
    for more in ys[1:]:   # the combine pass, in part order
        y = y + more
    return y, np.concatenate(states, axis=1)


def ema_walk_emulation(x, dt, g, *, itemsize: int = 4) -> np.ndarray:
    """y [T, D] as ``ssm_ema_kernel`` computes it at this card's plan:
    blocks of CH channels (the last partial), each channel walking its
    steps in order; channels past D are never stored."""
    t_len, d = x.shape
    plan = ema_plan(t_len, d, itemsize, n_sm=H100_SMS)
    width = plan.blocks(d) * plan.channels
    assert width - plan.channels < d <= width
    pad = ((0, 0), (0, width - d))
    xp, dtp, gp = (np.pad(a, pad) for a in (x, dt, g))
    h = np.zeros(width, dtype=np.float32)
    y = np.empty((t_len, width), dtype=np.float32)
    for t in range(t_len):
        h = dtp[t] * h + xp[t]
        y[t] = gp[t] * h
    return y[:, :d]


def moe_tiled_emulation(x, w, eid) -> np.ndarray:
    """y [T, F] = x[t] @ w[eid[t]] in float32 as ``moe_gemm_f32`` walks
    it: each N-tile's columns accumulated over K stages whose columns past
    D are zero (x's and w's alike); columns past F are dropped."""
    t_len, d = x.shape
    _, _, f = w.shape
    k_pad = -d % K_STAGE
    n_pad = -f % N_TILE
    xp = np.pad(x, ((0, 0), (0, k_pad)))
    wp = np.pad(w, ((0, 0), (0, k_pad), (0, n_pad)))
    acc = np.zeros((t_len, f + n_pad), dtype=np.float32)
    for k0 in range(0, d + k_pad, K_STAGE):
        xs = xp[:, k0:k0 + K_STAGE]
        ws = wp[eid, k0:k0 + K_STAGE]
        for k in range(K_STAGE):
            acc = _fma(xs[:, k:k + 1], ws[:, k], acc)
    return acc[:, :f]
