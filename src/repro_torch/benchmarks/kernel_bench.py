"""Kernel micro-benchmarks of the port's Hopper kernels (counterpart of the
reference's ``benchmarks/kernel_bench.py``), and the one home of the
card's timer, identity and published peaks.

On the card each row times the port's CUDA kernel through its ``ops``
entry point with CUDA events (median of 10 runs after 3 warm-ups, the L2
flushed before each run), beside the one PyTorch call that computes the
same function (``copy_``, ``mul``, ``add``, ``add(alpha=)``,
``scaled_dot_product_attention``) and the card's roof for the work: the
bytes over its HBM rate for STREAM, the flops over its bf16 dense
tensor-core rate for attention (``PEAKS``, chosen by the card's name; a
card without published peaks raises).  Every row names the card and its
power limit, as ``nvidia-smi`` gives them, since a card set below its
maximum power runs slower under load.

With ``device="cpu"`` the rows time the kernels' plain PyTorch versions on
the host, say so in their column name, and carry no roof.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import attention_ref, mha
from repro_torch.kernels.stream import ops as stream_ops
from repro_torch.kernels.stream import ref as stream_ref

__all__ = ["stream_rows", "attention_rows", "stream_calls", "stream_inputs",
           "attention_inputs", "card_identity", "card_peaks", "CardBench",
           "PEAKS", "STREAM_N", "STREAM_Q", "ATTENTION_SHAPES"]

WARMUP, REPS = 3, 10
FLUSH_BYTES = 1 << 30   # > 50 MB L2, and long enough to hide the enqueue
STREAM_N = 4 * 2**20    # 4 Mi f32 elements, 16 MB an array
STREAM_Q = 3.0
# (batch, seq, query heads, kv heads, head_dim), bf16, causal
ATTENTION_SHAPES = ((1, 1024, 8, 8, 128), (1, 2048, 8, 2, 128))

# Published dense peaks of the SXM parts (NVIDIA data sheets): HBM bytes/s,
# bf16 and f16 tensor-core and f32 CUDA-core flop/s, keyed by what
# nvidia-smi calls the card ("NVIDIA H100 80GB HBM3" is the H100 SXM).
# ``f32_issue``: f32 lane-instructions a second (132 SMs x 128 lanes x the
# 1.98 GHz boost clock), the floor of a kernel that may not fuse its
# multiplies and adds (the state-expanded scan's op-by-op update).
PEAKS = {
    "H100 80GB HBM3": dict(bytes=3.35e12, bf16=989e12, f16=989e12,
                           f32=67e12, f32_issue=132 * 128 * 1.98e9),
    "H200": dict(bytes=4.8e12, bf16=989e12, f16=989e12, f32=67e12,
                 f32_issue=132 * 128 * 1.98e9),
}


def card_peaks(name: str) -> dict:
    """``PEAKS`` of the card called ``name``; raises for any other card."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for card {name!r}")


def card_identity() -> tuple[str, str]:
    """(name, power limit) of card 0 as ``nvidia-smi`` reports them;
    ``", ".join`` of the pair is its csv line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


class CardBench:
    """CUDA-event timing and the bound for one card (``peaks``; by default
    card 0's, by its name)."""

    def __init__(self, peaks: dict | None = None) -> None:
        self.peaks = (card_peaks(torch.cuda.get_device_name(0))
                      if peaks is None else peaks)
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def once(self, fn) -> float:
        """ms of one run of ``fn`` after an L2 flush."""
        self.flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def ms(self, fn) -> float:
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        return statistics.median(self.once(fn) for _ in range(REPS))

    def turns(self, calls: list[tuple[str, object]], rounds: int
              ) -> dict[str, float]:
        """Median ms of each named call, timed in turns: every round runs
        the calls in the order given (a name may come twice)."""
        for _, fn in calls:
            fn()
        times: dict[str, list[float]] = {name: [] for name, _ in calls}
        for _ in range(rounds):
            for name, fn in calls:
                times[name].append(self.once(fn))
        return {name: statistics.median(t) for name, t in times.items()}

    def bound(self, nbytes: float, ops: float, rate: str) -> tuple[float, str]:
        t_bytes = nbytes / self.peaks["bytes"] * 1e3
        t_ops = ops / self.peaks[rate] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _host_ms(fn) -> float:
    """Median host wall-clock ms of ``fn`` (the plain versions on the CPU)."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def stream_calls() -> dict:
    """op -> (kernel's entry point, plain version, library call's name,
    library call into a preallocated output), on (a, b, q[, out])."""
    return {
        "copy": (lambda a, b, q: stream_ops.stream_copy(a),
                 lambda a, b, q: stream_ref.copy_ref(a),
                 "copy_", lambda a, b, q, o: o.copy_(a)),
        "scale": (lambda a, b, q: stream_ops.stream_scale(a, q),
                  lambda a, b, q: stream_ref.scale_ref(a, q),
                  "mul", lambda a, b, q, o: torch.mul(a, q, out=o)),
        "add": (lambda a, b, q: stream_ops.stream_add(a, b),
                lambda a, b, q: stream_ref.add_ref(a, b),
                "add", lambda a, b, q, o: torch.add(a, b, out=o)),
        "triad": (lambda a, b, q: stream_ops.stream_triad(a, b, q),
                  lambda a, b, q: stream_ref.triad_ref(a, b, q),
                  "add(alpha=)",
                  lambda a, b, q, o: torch.add(a, b, alpha=q, out=o)),
    }


def stream_inputs(device: str = "cuda"):
    """The STREAM rows' (a, b): ``STREAM_N`` f32 elements each, seed 0."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    return (torch.randn(STREAM_N, generator=gen, device=dev),
            torch.randn(STREAM_N, generator=gen, device=dev))


def stream_rows(device: str = "cuda"):
    """STREAM copy/scale/add/triad at ``STREAM_N`` f32 elements."""
    a, b = stream_inputs(device)
    q = STREAM_Q
    rows = []
    if a.device.type == "cpu":
        for op, (_, plain, _, _) in stream_calls().items():
            ms = _host_ms(lambda: plain(a, b, q))
            rows.append((f"stream_{op}", round(ms, 4),
                         stream_ops.bytes_moved(op, STREAM_N, 4)))
        return rows, ("kernel", "plain_cpu_ms", "bytes")
    name, limit = card_identity()
    bench = CardBench()
    out = torch.empty_like(a)
    for op, (entry, plain, lib_name, lib) in stream_calls().items():
        err = (entry(a, b, q) - plain(a, b, q)).abs().max().item()
        ms = bench.ms(lambda: entry(a, b, q))
        lib_ms = bench.ms(lambda: lib(a, b, q, out))
        nbytes = stream_ops.bytes_moved(op, STREAM_N, 4)
        roof, _ = bench.bound(nbytes, 0, "f32")
        rows.append((f"stream_{op}", round(ms, 4), lib_name,
                     round(lib_ms, 4), nbytes, round(roof, 4),
                     round(roof / ms, 3), err, name, limit))
    return rows, ("kernel", "cuda_ms", "library", "library_ms", "bytes",
                  "hbm_roof_ms", "roof_share", "max_abs_err", "card",
                  "power_limit")


def _attention_flops(b: int, s: int, h: int, d: int) -> int:
    """Causal: two products of 2 D flops over the S (S + 1) / 2 pairs."""
    return 4 * b * h * d * s * (s + 1) // 2


def attention_inputs(device: str = "cuda"):
    """The attention rows' bf16 (shape, q, k, v) at ``ATTENTION_SHAPES``,
    one generator seeded 0 for all; q [B, S, H, D], k and v [B, S, G, D]."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in ATTENTION_SHAPES:
        b, s, h, g, d = shape
        q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(b, s, g, d, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        yield shape, q, k, v


def attention_rows(device: str = "cuda"):
    """Causal bf16 GQA attention at ``ATTENTION_SHAPES``."""
    import torch.nn.functional as F

    rows = []
    card = bench = None
    for (b, s, h, g, d), q, k, v in attention_inputs(device):
        label = f"attn_b{b}s{s}h{h}g{g}"
        flops = _attention_flops(b, s, h, d)
        if q.device.type == "cpu":
            rows.append((label, round(_host_ms(
                lambda: attention_ref(q, k, v, causal=True)), 4), flops))
            continue
        if bench is None:
            card, bench = card_identity(), CardBench()
        want = attention_ref(q.float(), k.float(), v.float(), causal=True)
        err = (mha(q, k, v, causal=True).float() - want).abs().max().item()
        del want
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = bench.ms(lambda: mha(q, k, v, causal=True))
        lib_ms = bench.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=d ** -0.5, enable_gqa=True))
        roof, _ = bench.bound(0, flops, "bf16")
        rows.append((label, round(ms, 4), "sdpa", round(lib_ms, 4), flops,
                     round(roof, 4), round(roof / ms, 3), err, *card))
    if bench is None:
        return rows, ("kernel", "plain_cpu_ms", "flops")
    return rows, ("kernel", "cuda_ms", "library", "library_ms", "flops",
                  "bf16_roof_ms", "roof_share", "max_abs_err", "card",
                  "power_limit")
