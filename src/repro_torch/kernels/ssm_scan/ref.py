"""Plain PyTorch versions of the SSM scans (counterparts of
``repro.kernels.ssm_scan.ref``): sequential loops over time in float32,
cast to x's dtype."""

from __future__ import annotations

import torch

__all__ = ["ssm_ema_ref", "ssm_chunked_ref"]


def ssm_ema_ref(x: torch.Tensor, dt: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """x, dt, g: [T, D] -> y: [T, D] with h_t = dt_t h_{t-1} + x_t and
    y_t = g_t h_t."""
    xf, dtf, gf = x.float(), dt.float(), g.float()
    h = torch.zeros_like(xf[0])
    y = torch.empty_like(xf)
    for t in range(x.shape[0]):
        h = dtf[t] * h + xf[t]
        y[t] = gf[t] * h
    return y.to(x.dtype)


def ssm_chunked_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """x, dt: [T, D]; b, c: [T, N] -> y: [T, D] with the [N, D] state
    h_t = dt_t h_{t-1} + b_t (outer) x_t and y_t = c_t . h_t."""
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    h = torch.zeros(b.shape[1], x.shape[1], dtype=torch.float32,
                    device=x.device)
    y = torch.empty_like(xf)
    for t in range(x.shape[0]):
        h = dtf[t][None, :] * h + bf[t][:, None] * xf[t][None, :]
        y[t] = (cf[t][:, None] * h).sum(dim=0)
    return y.to(x.dtype)
