"""SSM scan entry points (counterpart of ``repro.kernels.ssm_scan.ops``).

The launch specs are the reference's chunk grids ``(T // chunk,)``: step
``i`` moves the ``(chunk, D)`` blocks of x, dt (and g) or the ``(chunk,
N)`` blocks of b and c in, and the ``(chunk, D)`` block of y out.  The
recurrent state is kernel-private and never an operand.  ``flops`` is the
reference's ``scan_flops``.  On the card the kernels take every T, D >= 1
and N >= 1; on the CPU the plain versions compute.

:func:`ema_scan` and :func:`chunked_scan` are the reference's public
dispatchers: where the reference runs its kernel (D % 128 == 0 and T a
multiple of ``chunk``) they are :func:`ssm_ema_scan` and
:func:`ssm_chunked_scan`, spec and all; elsewhere the reference's oracle
launches no Pallas kernel and they emit no spec, computing on the CPU
through the plain versions and on the card through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.capture.launch import LaunchOperand, LaunchSpec, emit

from .. import _build
from .kernel import ssm_chunked_cuda, ssm_ema_cuda
from .ref import ssm_chunked_ref, ssm_ema_ref

__all__ = ["ssm_ema_scan", "ssm_chunked_scan", "ema_scan", "chunked_scan",
           "launch_spec", "scan_flops", "SSM_OPS"]

SSM_OPS = ("ema", "expand")


def scan_flops(op: str, *, seq_len: int, d: int, n: int, chunk: int) -> float:
    """Arithmetic ops of one scan over ``seq_len`` steps."""
    n_chunks = seq_len // chunk
    if op == "ema":
        # cumprod + div + cumsum + state mul/add + gate, per element
        return 6.0 * seq_len * d
    # chunk closed form: gram [C,C,N] + masked matmul [C,C,D] + two
    # state contractions [C,N,D] + the vector epilogue
    return n_chunks * (2.0 * chunk * chunk * (n + d)
                       + 4.0 * chunk * n * d + 5.0 * chunk * d)


def launch_spec(op: str, t: int, d: int, n: int, chunk: int,
                dtype: torch.dtype) -> LaunchSpec:
    """The launch geometry of one scan over ``t`` steps (``n`` is the
    state width of ``op="expand"``; ``"ema"`` ignores it)."""
    if op not in SSM_OPS:
        raise ValueError(f"unknown ssm op {op!r}; expected {SSM_OPS}")
    if chunk < 1 or t % chunk:
        raise ValueError(f"seq_len {t} not a multiple of chunk {chunk}")

    def stream(name: str, role: str, width: int) -> LaunchOperand:
        return LaunchOperand(name=name, role=role, shape=(t, width),
                             block_shape=(chunk, width), dtype=dtype,
                             index_map=lambda i: (i, 0))

    if op == "ema":
        operands = (stream("x", "in", d), stream("dt", "in", d),
                    stream("g", "in", d), stream("y", "out", d))
    else:
        operands = (stream("x", "in", d), stream("dt", "in", d),
                    stream("b", "in", n), stream("c", "in", n),
                    stream("y", "out", d))
    return LaunchSpec(name=f"ssm_{op}", grid=(t // chunk,), operands=operands,
                      flops=scan_flops(op, seq_len=t, d=d, n=n, chunk=chunk))


def ssm_ema_scan(x: torch.Tensor, dt: torch.Tensor, g: torch.Tensor, *,
                 chunk: int = 128) -> torch.Tensor:
    """x, dt, g: [T, D] -> y: [T, D] with y_t = g_t (dt_t h_{t-1} + x_t)."""
    t, d = x.shape
    if dt.shape != x.shape or g.shape != x.shape:
        raise ValueError("ssm_ema_scan: x, dt and g must share one [T, D] "
                         "shape")
    spec = launch_spec("ema", t, d, 0, chunk, x.dtype)
    emit(spec)
    if _build.on_card(x, dt, g):
        return ssm_ema_cuda(spec, x, dt, g)
    return ssm_ema_ref(x, dt, g)


def ssm_chunked_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """x, dt: [T, D]; b, c: [T, N] -> y: [T, D], the state-expanded
    recurrence h_t = dt_t h_{t-1} + b_t (outer) x_t, y_t = c_t . h_t."""
    t, d = x.shape
    n = b.shape[1]
    if dt.shape != x.shape or b.shape != (t, n) or c.shape != (t, n):
        raise ValueError("ssm_chunked_scan: expected x, dt [T, D] and b, c "
                         "[T, N]")
    spec = launch_spec("expand", t, d, n, chunk, x.dtype)
    emit(spec)
    if _build.on_card(x, dt, b, c):
        return ssm_chunked_cuda(spec, x, dt, b, c)
    return ssm_chunked_ref(x, dt, b, c)


def _uses_kernel(t: int, d: int, chunk: int) -> bool:
    """Whether the reference's dispatchers run their kernel: D % 128 == 0
    and T a multiple of ``chunk``."""
    return d % 128 == 0 and chunk >= 1 and t % chunk == 0


def ema_scan(x: torch.Tensor, dt: torch.Tensor, g: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """The reference's ``ema_scan``: :func:`ssm_ema_scan` where it runs its
    kernel, else the scan with no launch spec (plain version on the CPU,
    the kernel over the whole T on the card)."""
    t, d = x.shape
    if _uses_kernel(t, d, chunk):
        return ssm_ema_scan(x, dt, g, chunk=chunk)
    if _build.on_card(x, dt, g):
        return ssm_ema_cuda(launch_spec("ema", t, d, 0, t, x.dtype), x, dt, g)
    return ssm_ema_ref(x, dt, g)


def chunked_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """The reference's ``chunked_scan``: :func:`ssm_chunked_scan` where it
    runs its kernel, else the scan with no launch spec (plain version on
    the CPU, the kernel over the whole T on the card)."""
    t, d = x.shape
    n = b.shape[1]
    if _uses_kernel(t, d, chunk):
        return ssm_chunked_scan(x, dt, b, c, chunk=chunk)
    if _build.on_card(x, dt, b, c):
        return ssm_chunked_cuda(launch_spec("expand", t, d, n, t, x.dtype),
                                x, dt, b, c)
    return ssm_chunked_ref(x, dt, b, c)
