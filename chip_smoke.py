#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. prints the card's name and power limit (``nvidia-smi``) and builds
   every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   all started together); prints each kernel's ptxas registers/spills and
   counts the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions of
   the flash and MoE libraries with ``cuobjdump -sass``, failing if bf16
   flash or bf16 MoE dispatch has no ``HGMMA``, or if the f32 flash kernel,
   either SSM scan or the simulator's window count spills;
2. holds each kernel against its plain PyTorch version on the card at
   full width, in float32 and bf16: qwen2.5-14b for STREAM, gather, flash
   and paged decode (40 query heads, 8 KV heads, head_dim 128, vocab
   152064; bf16 flash also at head_dim 64); one DeepSeek-MoE-16B layer's
   routed dispatch (4096 tokens, top-6 of 64 experts, d_model 2048,
   d_ff_expert 1408); one Zamba2-7B Mamba-2 layer's scans (T 4096, d_inner
   7168, ssm_state 64, chunk 128); f32 flash also on two causal launches
   its plan cuts into several kv ranges, some wholly above the diagonal;
   the EMA scan also at T 1000, whose last ring stage is cut short; and
   the simulator's window count (``window_scan``) on seeded rows, int32
   and int64 (ragged spans, cold slots, windows ending at m - 1 and past
   it), exactly, at every (lanes, steps) its plan picks (chunks 1-1024)
   with a ragged last tile;
3. times each kernel at full width with CUDA events (median of 10 after
   3 warm-ups, L2 flushed before each), beside its plain version, the one
   PyTorch call that computes the same function where there is one, and
   the least time the card could take (bytes over its memory rate or
   operations over its peak rate for their type, whichever is larger).
   STREAM is timed in turns instead: its library call and its kernel,
   both writing into one preallocated output, and its entry point, which
   allocates its output; each is first checked bit for bit against the
   plain version.  Flash is timed causal and not (f32 and bf16), beside
   SDPA, the f32 rows with the plan's kv split.  Paged decode prints its
   split count, the EMA scan its plan, the state-expanded scan its plan
   and its issue floor (4 N D T f32 lane-instructions, the update's
   multiplies and adds unfused);
   bf16 MoE dispatch prints, where the card's torch has it,
   ``torch._grouped_mm`` on x already gathered into sorted order as
   ``grouped_mm_ms`` (a yardstick for the GEMM alone).  Paged decode, MoE
   dispatch, flash and both scans draw their inputs from a seed of their
   own, here and in phase 8, and ``scripts/kernel_ab.py``
   times another checkout's kernels through the same functions on the same
   data;
4. main path 1, traced with ``repro_torch.obs`` (as are paths 2 and 3):
   sets every launch counter to 0, runs the 45-entry roster
   (``SuiteRunner(default_registry(device="cuda"), store=None)``: 21
   synthetic entries at ``DEFAULT_REFS`` and 24 captured ones, the full
   core sweep) on the card recording every launch's spec, reads the
   counters, prints the seconds of each source, checks 45/45 classes as
   expected, all seven capture kernels launched, and rows equal to the
   roster run on the CPU; prints its span split (seconds of simulation,
   trace generation, trace walk, per-launch synchronize and entries, every
   span and counter) and checks ``0 < profile.scan <= profile.geom``;
5. main path 2: sets the counters to 0 again, runs ``measure_windows``
   for the 16 serving scenarios (``repro_torch.serving``) on the card,
   reads the counters, checks that flash attention, paged decode and MoE
   dispatch launched, and that every scenario's window traces, timeline
   and whole-trace label equal the same run on the CPU; its span split;
6. holds each kernel against its plain version again at every distinct
   launch of both paths: its shapes and tiles, with its own index vectors
   (gather rows; page table, also reversed; MoE token order and expert
   ids) and, for the scans, its chunk; every flash shape also recast to
   bf16 at head_dim 64 and 128, causal and not; then flash at the
   reference's other tiles (``block_q`` or ``block_k`` 256), float32 and
   bf16, causal and not;
7. MoE dispatch's tile list: the pre-pass run alone on the card at every
   distinct main-path MoE launch equals ``plan.tile_list``; dispatches
   with an unsorted ``eid`` and with runs of 1, 7, 64, 127, 128 and 129
   rows (f32 and bf16, into outputs filled with NaN) match the plain
   version;
8. prints paged decode's split count at each main-path geometry, and
   times paged decode and MoE dispatch at the main paths' geometries (the
   captured roster's four of each and the serving roster's one), flash
   attention at every distinct flash launch of both paths (with its kv
   split) and both scans at every distinct launch of the roster's (with
   their plans), in float32, each checked against the plain version
   first;
9. checks, in child processes, that an out-of-range gather index, page
   or MoE expert id makes the launch fail rather than read past the table;
Paths 3-5 first drop the capture and window memos, so each launches its
kernels as a fresh process does:

10. main path 3: the same roster with the ``scalability`` and ``energy``
   sections, counters reset before and read after: every kernel
   launched, 45/45, its first 12 columns phase 4's rows, all of it equal
   to the CPU run's; its span split;
11. main path 4: the serving section (``registry_for(sections=
   ("serving",), device="cuda")``), counters reset before and read after:
   flash, paged decode and MoE dispatch launched, 16/16, each
   ``phase_timeline`` phase 5's timeline, rows equal to the CPU run's;
12. main path 5, at ``FAST_REFS``, in a temporary result store: a CPU run
   fills it and the card's first run recalls none of its rows (computes
   45), a second runner recalls all 45 with no simulation (and counts
   ``store.recall.warm`` 45, ``engine.sim.run`` 0), and two spawned
   worker processes give the same rows;
13. main paths 6 and 7: the roster through ``SuiteRunner.roster()`` with
   the vectorized and the ``cuda`` backend in turns (vectorized, cuda,
   cuda, vectorized), then the sections with ``backend="cuda"`` (beside
   phase 10's seconds), each traced with its span split, counters reset
   before and read after: 45/45, rows equal to the vectorized run's,
   ``scan.cuda`` > 0 and window-count launches > 0 (one a chunk step),
   the first cuda roster's and the sections' window counts recorded;
14. the window count at every distinct (rows, chunk) of paths 6-7, on its
   own recorded q and rows, exactly against the plain version; the three
   largest timed beside the plain version, the same PyTorch expression
   as the library yardstick, and its bytes bound: each q slot that some
   window reads, read once, plus each row's lo, thr, span and count (the
   slots counted once a window, and both in 32-byte sectors, printed
   beside it);
15. ``simulate_chunked`` over the reference tests' megaref trace at 10M
   refs, with the NumPy scan and with ``scan="cuda"``: equal counters;
   both equal the in-memory ``simulate`` on a 200 000-ref prefix;
16. prints the kernels line (``launches`` summed over main paths 1 and 2,
   as before, for the seven capture kernels and main path 6's first
   cuda run for the window count; ``launches_by_path`` for paths 1-4, 6
   and 7; flash's also split by kernel; the f32 (window count: int32)
   timings, and the bf16 ones as ``bf16_ms``, ``bf16_bound_ms``,
   ``bf16_library_ms``) and, last, ``{"ok": true, "device": ...}``.

Tolerances: gather is exact, and so is the EMA scan in float32, which
rounds op by op in the plain version's order.  STREAM's plain version
rounds op by op as the kernel does, so both dtypes are held to the
float32 tolerance of the CPU tests (rtol 1e-5, atol 1e-6).  Attention,
paged decode and MoE dispatch in float32: rtol 1e-4, atol 2e-5 (MoE's is
the reference's).  The state-expanded scan in float32: rtol 1e-4 and atol
1e-4 of the output's rms; its state is rounded as the plain version's,
but y_t's sum over the N state rows is taken in another order, whose
error is at most N 2^-24 sum|c h|, about 3e-5 of the rms at N = 64.  In
bf16 every kernel but STREAM is held against the plain version computed
in float32 on the same bf16 inputs (the kernels compute in float32, bf16
flash's P.V on two bf16 halves of P, and round once): rtol 1e-2, 2.5x the
bf16 rounding of a value (2^-8), and atol 1e-3 of the output's rms.

The window count is exact (integer counts).

It exits non-zero without a result when no CUDA device is available, and
when run outside a checkout (it imports the package from ``src/`` beside
itself).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

WARMUP, REPS = 3, 10
FLUSH_BYTES = 1 << 30   # > 50 MB L2, and long enough to hide the enqueue

# Published dense peaks of the SXM parts (NVIDIA data sheets): HBM bytes/s,
# bf16 tensor-core and f32 CUDA-core flop/s, keyed by what nvidia-smi calls
# the card ("NVIDIA H100 80GB HBM3" is the H100 SXM).
# ``f32_issue``: f32 lane-instructions a second (132 SMs x 128 lanes x the
# 1.98 GHz boost clock), the floor of a kernel that may not fuse its
# multiplies and adds (the state-expanded scan's op-by-op update).
PEAKS = {
    "H100 80GB HBM3": dict(bytes=3.35e12, bf16=989e12, f32=67e12,
                           f32_issue=132 * 128 * 1.98e9),
    "H200": dict(bytes=4.8e12, bf16=989e12, f32=67e12,
                 f32_issue=132 * 128 * 1.98e9),
}

KERNEL_SITES = {
    "stream": ("src/repro_torch/csrc/stream.cu",
               "src/repro/kernels/stream/kernel.py:59"),
    "token_gather": ("src/repro_torch/csrc/token_gather.cu",
                     "src/repro/kernels/token_gather/kernel.py:53"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:108"),
    "paged_kv_decode": ("src/repro_torch/csrc/paged_kv_decode.cu",
                        "src/repro/kernels/paged_kv_decode/kernel.py:96"),
    "moe_dispatch": ("src/repro_torch/csrc/moe_dispatch.cu",
                     "src/repro/kernels/moe_dispatch/kernel.py:60"),
    "ssm_ema_scan": ("src/repro_torch/csrc/ssm_ema_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:59"),
    "ssm_chunked_scan": ("src/repro_torch/csrc/ssm_chunked_scan.cu",
                         "src/repro/kernels/ssm_scan/kernel.py:112"),
    # not a pallas_call: the reference's jitted jax.numpy window count
    "window_scan": ("src/repro_torch/csrc/window_scan.cu",
                    "src/repro/core/cachesim_vec.py:307"),
}

# The simulator's window count launches only under backend="cuda" (main
# paths 6-7), never on the captured kernels' paths.
SCAN_KERNEL = "window_scan"


def say(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def card_peaks(name: str) -> dict:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for card {name!r}")


class Bench:
    """CUDA-event timing and the bound for one card."""

    def __init__(self, peaks: dict) -> None:
        self.peaks = peaks
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

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


STREAM_ROUNDS = 15          # in-turns rounds of the STREAM timings
STREAM_TOL = (1e-5, 1e-6)   # (rtol, atol), both dtypes
ATTN_TOL = (1e-4, 2e-5)     # flash, paged decode and MoE dispatch, float32
CHUNKED_RTOL, CHUNKED_ATOL_RMS = 1e-4, 1e-4   # state-expanded scan, float32
BF16_RTOL, BF16_ATOL_RMS = 1e-2, 1e-3


def check_close(kernel: str, case: str, got, want, *, exact=False,
                tol: tuple[float, float] = (0.0, 0.0), show=True) -> float:
    """Assert the kernel's output matches the plain version's ``want``
    within ``(rtol, atol)``; returns the max abs error.  Prints one JSON
    line when ``show`` (always when the check fails)."""
    torch.cuda.synchronize()
    got32, want32 = got.float(), want.float()
    err = (got32 - want32).abs().max().item()
    rtol, atol = tol
    ok = (torch.equal(got, want) if exact
          else torch.allclose(got32, want32, rtol=rtol, atol=atol))
    ok = bool(ok) and bool(torch.isfinite(got32).all())
    if show or not ok:
        say({"phase": "parity", "kernel": kernel, "case": case,
             "dtype": str(got.dtype).replace("torch.", ""),
             "max_abs_err": err, "want_rms": rms(want32),
             "tolerance": "exact" if exact else {"rtol": rtol, "atol": atol},
             "ok": ok})
    if not ok:
        raise AssertionError(f"{kernel} {case}: kernel disagrees with its "
                             f"plain version (max abs err {err})")
    return err


def rms(t: torch.Tensor) -> float:
    return t.float().pow(2).mean().sqrt().item()


def attn_tol(dtype: torch.dtype, want: torch.Tensor,
             f32: tuple[float, float] = ATTN_TOL) -> tuple[float, float]:
    """Tolerance of a kernel that computes in float32: ``f32`` for float32
    inputs, or for bf16 (``want`` computed in float32 on the bf16 inputs)
    a limit scaled to the output."""
    if dtype == torch.float32:
        return f32
    return BF16_RTOL, BF16_ATOL_RMS * rms(want)


def chunked_tol(dtype: torch.dtype, want: torch.Tensor) -> tuple[float, float]:
    return attn_tol(dtype, want, (CHUNKED_RTOL, CHUNKED_ATOL_RMS * rms(want)))


# An out-of-range index, or a MoE token order that repeats a token, must
# fail the launch, as the plain version raises.
BAD_INDEX = {
    "token_gather": (
        "from repro_torch.kernels.token_gather import gather\n"
        "t = torch.zeros(4, 128, device='cuda')\n"
        "gather(t, torch.tensor([0, 4], dtype=torch.int32, device='cuda'))\n"),
    "paged_kv_decode": (
        "from repro_torch.kernels.paged_kv_decode import paged_decode\n"
        "p = torch.zeros(4, 16, 128, device='cuda')\n"
        "paged_decode(torch.zeros(1, 128, device='cuda'), p, p,\n"
        "             torch.tensor([1, 4], dtype=torch.int32, device='cuda'))\n"),
    "moe_dispatch": (
        "from repro_torch.kernels.moe_dispatch import moe_dispatch_sorted\n"
        "ids = lambda *v: torch.tensor(v, dtype=torch.int32, device='cuda')\n"
        "moe_dispatch_sorted(torch.zeros(4, 128, device='cuda'),\n"
        "                    torch.zeros(2, 128, 128, device='cuda'),\n"
        "                    ids(0, 1, 2, 3), ids(0, 0, 1, 2))\n"),
    "moe_dispatch:repeated_token": (
        "from repro_torch.kernels.moe_dispatch import moe_dispatch_sorted\n"
        "ids = lambda *v: torch.tensor(v, dtype=torch.int32, device='cuda')\n"
        "moe_dispatch_sorted(torch.zeros(4, 128, device='cuda'),\n"
        "                    torch.zeros(2, 128, 128, device='cuda'),\n"
        "                    ids(0, 1, 1, 3), ids(0, 0, 1, 1))\n"),
}


def check_bad_index() -> None:
    """Run each BAD_INDEX snippet in its own process (a trapped launch
    leaves that process's CUDA context unusable) and require it to fail
    with a CUDA error at the synchronize."""
    head = f"import sys, torch\nsys.path.insert(0, {str(ROOT / 'src')!r})\n"
    procs = {k: subprocess.Popen(
        [sys.executable, "-c",
         head + code + "torch.cuda.synchronize()\nprint('no error')\n"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, code in BAD_INDEX.items()}
    for kernel, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        failed = (proc.returncode != 0 and "no error" not in out
                  and "CUDA error" in err)
        say({"phase": "bad-index", "kernel": kernel,
             "exit": proc.returncode, "launch_failed": failed,
             "error": [ln for ln in err.splitlines() if "CUDA error" in ln]})
        if not failed:
            raise AssertionError(f"{kernel}: an out-of-range index did not "
                                 f"fail the launch:\n{out}\n{err}")


SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS")


def sass_counts(lib: Path) -> dict[str, dict[str, int]]:
    """Per kernel function of a built library, how many ``HGMMA`` (wgmma),
    ``UTMALDG`` (TMA load) and ``LDGSTS`` (cp.async) instructions its SASS
    holds (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn:
            for op in SASS_OPS:
                counts[fn][op] += len(re.findall(rf"\b{op}\b", line))
    return counts


def ptxas_spills(log: str) -> dict[str, int]:
    """Spill-store plus spill-load bytes of each function in one library's
    ptxas report (``-Xptxas -v``)."""
    spills, fn = {}, None
    for line in log.splitlines():
        head = re.search(r"Function properties for (\S+)", line)
        if head:
            fn = head.group(1)
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found and fn:
            spills[fn] = int(found.group(1)) + int(found.group(2))
    return spills


# Kernels redesigned to keep every value in registers: a spill fails phase 1.
NO_SPILL = {"flash_attention": "flash_fwd_kernel",
            "ssm_ema_scan": "ssm_ema_kernel",
            "ssm_chunked_scan": "ssm_chunked_kernel",
            "window_scan": "window_count_kernel"}


def stream_calls() -> dict:
    """op -> (kernel, plain version, library call) on (a, b, q[, out])."""
    from repro_torch.kernels.stream import ops, ref

    return {
        "copy": (lambda a, b, q: ops.stream_copy(a),
                 lambda a, b, q: ref.copy_ref(a),
                 lambda a, b, q, o: o.copy_(a)),
        "scale": (lambda a, b, q: ops.stream_scale(a, q),
                  lambda a, b, q: ref.scale_ref(a, q),
                  lambda a, b, q, o: torch.mul(a, q, out=o)),
        "add": (lambda a, b, q: ops.stream_add(a, b),
                lambda a, b, q: ref.add_ref(a, b),
                lambda a, b, q, o: torch.add(a, b, out=o)),
        "triad": (lambda a, b, q: ops.stream_triad(a, b, q),
                  lambda a, b, q: ref.triad_ref(a, b, q),
                  lambda a, b, q, o: torch.add(a, b, alpha=q, out=o)),
    }


def hold_main_path(launched: list, randn, rand,
                   errs: dict[str, float]) -> int:
    """Hold each kernel against its plain version at every distinct launch
    the main paths recorded: seeded inputs at the launch's shapes and
    tiles, with its own index vectors (gather rows; page table, also
    reversed; MoE token order and expert ids).  Prints one summary line per
    kernel, records each max abs error in ``errs`` and returns the
    distinct count."""
    from repro_torch.kernels.flash_attention import attention_ref, mha
    from repro_torch.kernels.moe_dispatch import (moe_dispatch_sorted,
                                                  moe_dispatch_sorted_ref)
    from repro_torch.kernels.paged_kv_decode import (paged_decode,
                                                     paged_decode_ref)
    from repro_torch.kernels.ssm_scan import (ssm_chunked_ref,
                                              ssm_chunked_scan, ssm_ema_ref,
                                              ssm_ema_scan)
    from repro_torch.kernels.token_gather import gather, gather_rows_ref

    streams = stream_calls()
    held_by: dict[str, int] = {}
    path_err: dict[str, float] = {}

    def check(kernel: str, case: str, got, want, **kw) -> None:
        err = check_close(kernel, f"main path {case}", got, want, show=False,
                          **kw)
        errs[kernel] = max(errs[kernel], err)
        path_err[kernel] = max(path_err.get(kernel, 0.0), err)

    def hold(spec) -> str:
        dtype = spec.operands[-1].dtype
        if spec.name.startswith("stream_"):
            op = spec.name.removeprefix("stream_")
            kern, plain, _ = streams[op]
            rows, lanes = spec.operand("o").shape
            a, b = randn(rows * lanes, dtype=dtype), randn(rows * lanes,
                                                           dtype=dtype)
            check("stream", f"{op} n={rows * lanes}", kern(a, b, 1.5),
                  plain(a, b, 1.5), tol=STREAM_TOL)
            return "stream"
        if spec.name == "token_gather":
            n_rows, d = spec.operand("table").shape
            table, (idx,) = randn(n_rows, d, dtype=dtype), spec.index
            check("token_gather", f"{n_rows}x{d} m={len(idx)}",
                  gather(table, idx), gather_rows_ref(table, idx), exact=True)
            return "token_gather"
        if spec.name == "flash_attention":
            (bh, sq, d), (_, bq, _) = (spec.operand("q").shape,
                                       spec.operand("q").block_shape)
            (bg, sk, _), (_, bk, _) = (spec.operand("k").shape,
                                       spec.operand("k").block_shape)
            qq = randn(1, sq, bh, d, dtype=dtype)
            kk, vv = (randn(1, sk, bg, d, dtype=dtype) for _ in range(2))
            want = attention_ref(qq.float(), kk.float(), vv.float(),
                                 causal=False)
            check("flash_attention", f"sq={sq} sk={sk} d={d}",
                  mha(qq, kk, vv, causal=False, block_q=bq, block_k=bk), want,
                  tol=attn_tol(dtype, want))
            for d16 in (64, 128):        # the shape recast to bf16
                qq = randn(1, sq, bh, d16, dtype=torch.bfloat16)
                kk, vv = (randn(1, sk, bg, d16, dtype=torch.bfloat16)
                          for _ in range(2))
                for causal in (True, False):
                    want = attention_ref(qq.float(), kk.float(), vv.float(),
                                         causal=causal)
                    check("flash_attention",
                          f"bf16 sq={sq} sk={sk} d={d16} causal={causal}",
                          mha(qq, kk, vv, causal=causal, block_q=bq,
                              block_k=bk), want,
                          tol=attn_tol(torch.bfloat16, want))
            return "flash_attention"
        if spec.name == "paged_kv_decode":
            h, d = spec.operand("q").shape
            n_pages, page, _ = spec.operand("k").shape
            qq = randn(h, d, dtype=dtype)
            kp, vp = (randn(n_pages, page, d, dtype=dtype) for _ in range(2))
            for table in (spec.index[0], spec.index[0].flip(0)):
                want = paged_decode_ref(qq.float(), kp.float(), vp.float(),
                                        table)
                check("paged_kv_decode",
                      f"pool={n_pages} page={page} h={h} n={len(table)}",
                      paged_decode(qq, kp, vp, table), want,
                      tol=attn_tol(dtype, want))
            return "paged_kv_decode"
        if spec.name == "moe_dispatch":
            t, d = spec.operand("x").shape
            n_exp, _, f = spec.operand("w").shape
            tok, eid = spec.index
            x = randn(t, d, dtype=dtype)
            w = randn(n_exp, d, f, dtype=dtype) / d ** 0.5
            want = moe_dispatch_sorted_ref(x.float(), w.float(), tok, eid)
            check("moe_dispatch", f"T={t} D={d} F={f} E={n_exp}",
                  moe_dispatch_sorted(x, w, tok, eid), want,
                  tol=attn_tol(dtype, want))
            return "moe_dispatch"
        if spec.name in ("ssm_ema", "ssm_expand"):
            t, d = spec.operand("x").shape
            chunk = spec.operand("x").block_shape[0]
            x = randn(t, d, dtype=dtype)
            dt = (0.95 + 0.049 * rand(t, d)).to(dtype)
            case = f"T={t} D={d} chunk={chunk}"
            if spec.name == "ssm_ema":
                g = randn(t, d, dtype=dtype)
                want = ssm_ema_ref(x.float(), dt.float(), g.float())
                check("ssm_ema_scan", case, ssm_ema_scan(x, dt, g, chunk=chunk),
                      want, **ema_tol(dtype, want))
                return "ssm_ema_scan"
            n = spec.operand("b").shape[1]
            b = randn(t, n, dtype=dtype) / n ** 0.5
            c = randn(t, n, dtype=dtype)
            want = ssm_chunked_ref(x.float(), dt.float(), b.float(), c.float())
            check("ssm_chunked_scan", f"{case} N={n}",
                  ssm_chunked_scan(x, dt, b, c, chunk=chunk), want,
                  tol=chunked_tol(dtype, want))
            return "ssm_chunked_scan"
        raise AssertionError(f"main path launched unknown {spec.name!r}")

    held = set()
    for spec in launched:
        key = (spec.name,
               tuple((op.shape, op.block_shape) for op in spec.operands),
               spec.operands[-1].dtype,
               tuple(t.cpu().numpy().tobytes() for t in spec.index))
        if key not in held:
            held.add(key)
            kname = hold(spec)
            held_by[kname] = held_by.get(kname, 0) + 1
    for kname, n in sorted(held_by.items()):
        say({"phase": "main-path-parity-kernel", "kernel": kname,
             "distinct_launches": n, "max_abs_err": path_err[kname],
             "ok": True})
    return len(held)


def check_reference_tiles(randn, errs: dict[str, float]) -> None:
    """Flash attention at the reference's other tiles (``block_q`` or
    ``block_k`` 256 against 128, ``tests/test_kernels.py``'s tile
    invariance cases), float32 and bf16, causal and not, against the plain
    version: the spec records the tile and the kernels walk their own."""
    from repro_torch.kernels.flash_attention import attention_ref, mha

    for dtype, (bq, bk), causal in itertools.product(
            (torch.float32, torch.bfloat16), ((256, 128), (128, 256)),
            (True, False)):
        q = randn(1, 512, 4, 128, dtype=dtype)
        k, v = (randn(1, 512, 2, 128, dtype=dtype) for _ in range(2))
        want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
        errs["flash_attention"] = max(errs["flash_attention"], check_close(
            "flash_attention", f"reference tile block_q={bq} block_k={bk} "
            f"s=512 h=4 g=2 d=128 causal={causal}",
            mha(q, k, v, causal=causal, block_q=bq, block_k=bk), want,
            tol=attn_tol(dtype, want)))


# Full width of the two redesigned kernels (qwen2.5-14b decode over a
# paged pool; one DeepSeek-MoE-16B layer's routed dispatch).
FULL_PAGED = dict(n_pages=65536, page=16, d=128, h=5, n_active=2048)
FULL_MOE = dict(n_tokens=4096, top_k=6, d=2048, f=1408, n_experts=64)


def main_path_geometries() -> tuple[list, list]:
    """(name, geometry) of paged decode and of MoE dispatch at the main
    paths' launches: the captured roster's four geometries of each
    (``capture/kernels.py``) and the serving roster's one
    (``serving/scenario.py``)."""
    from repro_torch.capture import kernels as cap
    from repro_torch.serving import scenario as srv

    paged = [(f"roster {tag}", geo) for tag, _, geo in cap._GEO_PAGED]
    g = dict(srv._GEO_PAGED)
    paged.append(("serving", dict(n_pages=g["n_pages"], page=g["page"],
                                  d=g["d"], h=g["h"],
                                  n_active=g["pages_per_seq"])))
    moe = [(f"roster {tag}", geo) for tag, _, geo in cap._GEO_MOE]
    g = dict(srv._GEO_MOE)
    moe.append(("serving", dict(n_tokens=g["tokens_per_req"], d=g["d"],
                                f=g["f"], n_experts=g["n_experts"])))
    return paged, moe


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def paged_splits(geo: dict, itemsize: int) -> int:
    """Splits the paged kernel takes at ``geo`` on this card."""
    from repro_torch.kernels.paged_kv_decode.plan import split_plan

    return split_plan(geo["n_active"], geo["page"], geo["d"], geo["h"],
                      itemsize, n_sm=sm_count())[1]


def paged_inputs(gen, geo: dict, dtype: torch.dtype):
    """q [H, D], the K and V pools [P, page, D] and a table of
    ``n_active`` distinct pages."""
    dev = torch.device("cuda")
    pt = torch.randperm(geo["n_pages"], generator=gen, device=dev)[
        :geo["n_active"]].to(torch.int32)
    q, kp, vp = (torch.randn(*shape, generator=gen, device=dev).to(dtype)
                 for shape in ((geo["h"], geo["d"]),
                               (geo["n_pages"], geo["page"], geo["d"]),
                               (geo["n_pages"], geo["page"], geo["d"])))
    return q, kp, vp, pt


def moe_inputs(gen, geo: dict, dtype: torch.dtype):
    """x [T, D], w [E, D, F], the expert of each row in token order and
    the sorted (tok, eid) of one dispatch: each token routed to ``top_k``
    distinct experts (its row repeated), or to one expert drawn
    uniformly."""
    dev = torch.device("cuda")
    n_tok, top_k = geo["n_tokens"], geo.get("top_k", 1)
    d, f, n_exp = geo["d"], geo["f"], geo["n_experts"]
    x = torch.randn(n_tok, d, generator=gen, device=dev).to(dtype)
    x = x.repeat_interleave(top_k, dim=0)
    w = (torch.randn(n_exp, d, f, generator=gen, device=dev) / d ** 0.5
         ).to(dtype)
    eids = torch.rand(n_tok, n_exp, generator=gen, device=dev).argsort(
        dim=1)[:, :top_k].reshape(-1)
    tok = torch.argsort(eids, stable=True).to(torch.int32)
    return x, w, eids, tok, eids[tok.long()].to(torch.int32)


def timing_row(bench: Bench, smi: str, kernel: str, case: str, dtype,
               ms: float, plain_ms: float, library_ms, nbytes: float,
               ops: float, rate: str, **extra) -> dict:
    """Print and return one full-width timing row with its bound."""
    bound_ms, bound_by = bench.bound(nbytes, ops, rate)
    row = {"phase": "timing", "kernel": kernel, "case": case,
           "dtype": str(dtype).replace("torch.", ""), "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / ms, **extra, "card": smi}
    say(row)
    return row


# Seed of the inputs of paged decode's and MoE dispatch's timings, drawn
# anew in each, so that phases 3 and 8 and scripts/kernel_ab.py (which
# times another checkout's kernels with these functions) see the same data.
TIMING_SEED = 1


def paged_full_width(bench: Bench, smi: str, dtype: torch.dtype,
                     **extra) -> tuple[dict, float]:
    """Paged decode at ``FULL_PAGED``: held against its plain version,
    then timed beside it.  Returns the timing row (printed, with
    ``extra``) and the max abs error."""
    from repro_torch.kernels.paged_kv_decode import (paged_decode,
                                                     paged_decode_ref)

    g = FULL_PAGED
    gen = torch.Generator(device="cuda").manual_seed(TIMING_SEED)
    q, kp, vp, pt = paged_inputs(gen, g, dtype)
    case = (f"pool={g['n_pages']} page={g['page']} h={g['h']} d={g['d']} "
            f"n={g['n_active']}")
    want = paged_decode_ref(q.float(), kp.float(), vp.float(), pt)
    err = check_close("paged_kv_decode", f"full {case}",
                      paged_decode(q, kp, vp, pt), want,
                      tol=attn_tol(dtype, want))
    del want
    isz = q.element_size()
    row = timing_row(
        bench, smi, "paged_kv_decode", case, dtype,
        bench.ms(lambda: paged_decode(q, kp, vp, pt)),
        bench.ms(lambda: paged_decode_ref(q, kp, vp, pt)), None,
        (2 * g["n_active"] * g["page"] * g["d"] + 2 * g["h"] * g["d"]) * isz
        + 4 * g["n_active"],
        4.0 * g["h"] * g["page"] * g["d"] * g["n_active"],
        "f32" if dtype == torch.float32 else "bf16", **extra)
    return row, err


def moe_full_width(bench: Bench, smi: str, dtype: torch.dtype,
                   **extra) -> tuple[dict, float]:
    """One DeepSeek-MoE-16B layer's routed dispatch (``FULL_MOE``): the
    unsorted entry point held against its plain version, then the sorted
    dispatch timed beside its plain version (and, in bf16, the
    ``torch._grouped_mm`` yardstick).  Returns the timing row (printed,
    with ``extra``) and the max abs error."""
    from repro_torch.kernels.moe_dispatch import (moe_dispatch,
                                                  moe_dispatch_ref,
                                                  moe_dispatch_sorted,
                                                  moe_dispatch_sorted_ref)

    g = FULL_MOE
    gen = torch.Generator(device="cuda").manual_seed(TIMING_SEED)
    x, w, eids, tok, eid = moe_inputs(gen, g, dtype)
    t, d, f = x.shape[0], g["d"], g["f"]
    case = f"T={t} D={d} F={f} E={g['n_experts']} top{g['top_k']}"
    want = moe_dispatch_ref(x.float(), w.float(), eids)
    err = check_close("moe_dispatch", f"full {case}",
                      moe_dispatch(x, w, eids), want,
                      tol=attn_tol(dtype, want))
    del want
    row = timing_row(
        bench, smi, "moe_dispatch", case, dtype,
        bench.ms(lambda: moe_dispatch_sorted(x, w, tok, eid)),
        bench.ms(lambda: moe_dispatch_sorted_ref(x, w, tok, eid)), None,
        (x.numel() + w.numel() + t * f) * x.element_size() + 8 * t,
        2.0 * t * d * f, "f32" if dtype == torch.float32 else "bf16",
        **extra)
    if dtype == torch.bfloat16:
        grouped_mm_yardstick(bench, x, w, tok, eid, smi)
    return row, err


# Full width of flash attention (qwen2.5-14b prefill: one 4096-token
# sequence, 40 query heads, 8 KV heads) and of the state-expanded scan (one
# Zamba2-7B Mamba-2 layer: T 4096, d_inner 7168, ssm_state 64, chunk 128).
FULL_FLASH = dict(b=1, s=4096, h=40, g=8)
FULL_SCAN = dict(t=4096, d=2 * 3584, n=64, chunk=128)


def flash_plan(b: int, h: int, sq: int, sk: int) -> dict:
    """The f32 kernel's kv split at one launch on this card, or nothing for
    a checkout from before the split design."""
    try:
        from repro_torch.kernels.flash_attention.plan import split_plan
    except ImportError:
        return {}
    per, n_splits = split_plan(b, h, sq, sk, n_sm=sm_count())
    return {"kv_rows_per_split": per, "n_splits": n_splits}


def scan_plan_of(t: int, d: int, n: int, itemsize: int) -> dict:
    """The chunked scan's plan at one launch on this card, or nothing for a
    checkout from before the plan."""
    try:
        from repro_torch.kernels.ssm_scan.plan import scan_plan
    except ImportError:
        return {}
    plan = scan_plan(t, d, n, itemsize, n_sm=sm_count())
    return {"rows_per_thread": plan.rows, "channels_per_block": plan.channels,
            "blocks": plan.blocks(d), "threads_per_block": plan.threads(n)}


def ema_plan_of(t: int, d: int, itemsize: int) -> dict:
    """The EMA scan's plan at one launch on this card, or nothing for a
    checkout from before the plan."""
    try:
        from repro_torch.kernels.ssm_scan.plan import ema_plan
    except ImportError:
        return {}
    plan = ema_plan(t, d, itemsize, n_sm=sm_count())
    return {"channels_per_block": plan.channels, "blocks": plan.blocks(d),
            "stage_steps": plan.stage_steps, "ring": plan.ring,
            "threads_per_block": plan.threads()}


def ema_tol(dtype: torch.dtype, want: torch.Tensor) -> dict:
    """check_close's limit for the EMA scan: float32 bit for bit (both
    round op by op in one order), bf16 against the f32 plain version."""
    if dtype == torch.float32:
        return {"exact": True}
    return {"tol": attn_tol(dtype, want)}


def flash_inputs(gen, b: int, sq: int, sk: int, h: int, g: int, d: int,
                 dtype: torch.dtype):
    """q [B, Sq, H, D] and k, v [B, Sk, G, D]."""
    dev = torch.device("cuda")
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, sk, g, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v


def flash_full_width(bench: Bench, smi: str, dtype: torch.dtype, d: int,
                     causal: bool, **extra) -> tuple[dict | None, float]:
    """Flash attention at ``FULL_FLASH`` and head width ``d``: held against
    its plain version (bf16 d 128 also prints SDPA's own error against the
    same limit), then, at d 128, timed beside its plain version and SDPA.
    Returns the timing row (printed, with ``extra``; None at d 64) and the
    max abs error."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref, mha

    g = FULL_FLASH
    gen = torch.Generator(device="cuda").manual_seed(TIMING_SEED)
    qq, kk, vv = flash_inputs(gen, g["b"], g["s"], g["s"], g["h"], g["g"], d,
                              dtype)
    case = (f"b={g['b']} s={g['s']} h={g['h']} g={g['g']} d={d} "
            f"causal={causal}")
    want = attention_ref(qq.float(), kk.float(), vv.float(), causal=causal)
    tol = attn_tol(dtype, want)
    err = check_close("flash_attention", f"full {case}",
                      mha(qq, kk, vv, causal=causal), want, tol=tol)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qq, kk, vv))

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=d ** -0.5, enable_gqa=True)

    if dtype == torch.bfloat16 and d == 128:
        # SDPA's own bf16 result against the same limit (for the record: it
        # rounds P to bf16 once).
        diff = (sdpa().transpose(1, 2).float() - want).abs()
        say({"phase": "sdpa-vs-plain", "case": case,
             "max_abs_err": diff.max().item(),
             "worst_over_limit": (diff / (tol[1] + tol[0] * want.abs())
                                  ).max().item()})
        del diff
    del want
    if d != 128:
        return None, err
    s, pairs_per_head = g["s"], g["s"] * (g["s"] + 1) // 2
    if not causal:
        pairs_per_head = g["s"] * g["s"]
    if dtype == torch.float32:
        extra = {**flash_plan(g["b"], g["h"], s, s), **extra}
    row = timing_row(
        bench, smi, "flash_attention", case, dtype,
        bench.ms(lambda: mha(qq, kk, vv, causal=causal)),
        bench.ms(lambda: attention_ref(qq, kk, vv, causal=causal)),
        bench.ms(sdpa),
        (2 * qq.numel() + kk.numel() + vv.numel()) * qq.element_size(),
        4.0 * d * g["b"] * g["h"] * pairs_per_head,
        "f32" if dtype == torch.float32 else "bf16", **extra)
    return row, err


def scan_inputs(gen, t: int, d: int, n: int, dtype: torch.dtype):
    """x, dt [T, D] (dt in (0.95, 0.999)) and b, c [T, N]."""
    dev = torch.device("cuda")
    x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
    dt = (0.95 + 0.049 * torch.rand(t, d, generator=gen, device=dev)
          ).to(dtype)
    b = (torch.randn(t, n, generator=gen, device=dev) / n ** 0.5).to(dtype)
    c = torch.randn(t, n, generator=gen, device=dev).to(dtype)
    return x, dt, b, c


def ema_inputs(gen, t: int, d: int, dtype: torch.dtype):
    """x, g [T, D] standard normal and dt [T, D] in (0.95, 0.999)."""
    dev = torch.device("cuda")
    x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
    dt = (0.95 + 0.049 * torch.rand(t, d, generator=gen, device=dev)
          ).to(dtype)
    g = torch.randn(t, d, generator=gen, device=dev).to(dtype)
    return x, dt, g


def ema_full_width(bench: Bench, smi: str, dtype: torch.dtype,
                   **extra) -> tuple[dict, float]:
    """The gated EMA scan at ``FULL_SCAN``'s T and D: held against its
    plain version (float32 bit for bit), then timed beside it, with its
    plan.  Returns the timing row (printed, with ``extra``) and the max abs
    error."""
    from repro_torch.kernels.ssm_scan import ssm_ema_ref, ssm_ema_scan

    t, d, chunk = FULL_SCAN["t"], FULL_SCAN["d"], FULL_SCAN["chunk"]
    gen = torch.Generator(device="cuda").manual_seed(TIMING_SEED)
    x, dt, g = ema_inputs(gen, t, d, dtype)
    case = f"T={t} D={d} chunk={chunk}"
    want = ssm_ema_ref(x.float(), dt.float(), g.float())
    err = check_close("ssm_ema_scan", f"full {case}",
                      ssm_ema_scan(x, dt, g, chunk=chunk), want,
                      **ema_tol(dtype, want))
    del want
    row = timing_row(
        bench, smi, "ssm_ema_scan", case, dtype,
        bench.ms(lambda: ssm_ema_scan(x, dt, g, chunk=chunk)),
        bench.ms(lambda: ssm_ema_ref(x, dt, g)), None,
        4 * t * d * x.element_size(), 6.0 * t * d, "f32",
        **ema_plan_of(t, d, x.element_size()), **extra)
    return row, err


def chunked_full_width(bench: Bench, smi: str, dtype: torch.dtype,
                       **extra) -> tuple[dict, float]:
    """The state-expanded scan at ``FULL_SCAN``: held against its plain
    version, then timed beside it, with the bound (the direct recurrence's
    5 N D T operations at the f32 peak) and the issue floor (its 4 N D T
    lane-instructions at ``f32_issue``).  Returns the timing row (printed,
    with ``extra``) and the max abs error."""
    from repro_torch.kernels.ssm_scan import ssm_chunked_ref, ssm_chunked_scan

    g = FULL_SCAN
    t, d, n, chunk = g["t"], g["d"], g["n"], g["chunk"]
    gen = torch.Generator(device="cuda").manual_seed(TIMING_SEED)
    x, dt, b, c = scan_inputs(gen, t, d, n, dtype)
    case = f"T={t} D={d} N={n} chunk={chunk}"
    want = ssm_chunked_ref(x.float(), dt.float(), b.float(), c.float())
    err = check_close("ssm_chunked_scan", f"full {case}",
                      ssm_chunked_scan(x, dt, b, c, chunk=chunk), want,
                      tol=chunked_tol(dtype, want))
    del want
    row = timing_row(
        bench, smi, "ssm_chunked_scan", case, dtype,
        bench.ms(lambda: ssm_chunked_scan(x, dt, b, c, chunk=chunk)),
        bench.ms(lambda: ssm_chunked_ref(x, dt, b, c)), None,
        (3 * t * d + 2 * t * n) * x.element_size(), 5.0 * n * d * t, "f32",
        issue_floor_ms=4.0 * n * d * t / bench.peaks["f32_issue"] * 1e3,
        **scan_plan_of(t, d, n, x.element_size()), **extra)
    return row, err


def record_main_paths(device: str) -> list:
    """The launch specs of both main paths (the 45-entry roster, then the
    16 serving scenarios) run on ``device``.  The roster runs at
    ``FAST_REFS``: only its captured entries launch, and their launches do
    not depend on the synthetic trace length."""
    from repro_torch.capture.launch import record
    from repro_torch.serving import SCENARIOS, measure_windows
    from repro_torch.suite import SuiteRunner, default_registry
    from repro_torch.suite.__main__ import FAST_REFS

    with record() as launched:
        SuiteRunner(default_registry(refs=FAST_REFS, device=device),
                    store=None).roster()
        for scen in SCENARIOS:
            measure_windows(scen, device=device)
    return launched


def launch_geometries(launched: list) -> dict[str, list]:
    """The distinct flash (``(bh, sq, bg, sk, d)``), state-expanded scan
    (``(t, d, n, chunk)``) and EMA scan (``(t, d, chunk)``) launches among
    ``launched``, in launch order."""
    found: dict[str, dict] = {"flash": {}, "scan": {}, "ema": {}}
    for spec in launched:
        if spec.name == "flash_attention":
            bh, sq, d = spec.operand("q").shape
            bg, sk, _ = spec.operand("k").shape
            found["flash"][(bh, sq, bg, sk, d)] = None
        elif spec.name in ("ssm_expand", "ssm_ema"):
            t, d = spec.operand("x").shape
            chunk = spec.operand("x").block_shape[0]
            if spec.name == "ssm_ema":
                found["ema"][(t, d, chunk)] = None
            else:
                found["scan"][(t, d, spec.operand("b").shape[1], chunk)] = None
    return {k: list(v) for k, v in found.items()}


GEOMETRY_KERNELS = ("paged", "moe", "flash", "scan", "ema")


def geometry_timings(bench: Bench, smi: str, launched: list,
                     only=GEOMETRY_KERNELS, **tags) -> list[dict]:
    """Time paged decode and MoE dispatch at the main paths' geometries,
    and flash attention, the state-expanded scan and the EMA scan at every
    distinct launch of theirs among ``launched``, through the entry points
    in float32, each first held against its plain version (the EMA scan
    bit for bit; ``only`` names which of the five); prints one row each
    (with ``tags``) and returns them."""
    from repro_torch.kernels.flash_attention import attention_ref, mha
    from repro_torch.kernels.moe_dispatch import (moe_dispatch_sorted,
                                                  moe_dispatch_sorted_ref)
    from repro_torch.kernels.paged_kv_decode import (paged_decode,
                                                     paged_decode_ref)
    from repro_torch.kernels.ssm_scan import (ssm_chunked_ref,
                                              ssm_chunked_scan, ssm_ema_ref,
                                              ssm_ema_scan)

    gen = torch.Generator(device="cuda").manual_seed(TIMING_SEED)
    paged, moe = main_path_geometries()
    f32 = torch.float32
    rows = []
    if "paged" not in only:
        paged = []
    if "moe" not in only:
        moe = []
    for name, g in paged:
        q, kp, vp, pt = paged_inputs(gen, g, f32)
        want = paged_decode_ref(q, kp, vp, pt)
        err = check_close("paged_kv_decode", f"timing {name}",
                          paged_decode(q, kp, vp, pt), want, tol=ATTN_TOL,
                          show=False)
        rows.append(dict(kernel="paged_kv_decode", case=name, geometry=g,
                         dtype="float32",
                         ms=bench.ms(lambda: paged_decode(q, kp, vp, pt)),
                         max_abs_err=err))
    for name, g in moe:
        x, w, _, tok, eid = moe_inputs(gen, g, f32)
        want = moe_dispatch_sorted_ref(x, w, tok, eid)
        err = check_close("moe_dispatch", f"timing {name}",
                          moe_dispatch_sorted(x, w, tok, eid), want,
                          tol=ATTN_TOL, show=False)
        rows.append(dict(kernel="moe_dispatch", case=name, geometry=g,
                         dtype="float32",
                         ms=bench.ms(lambda: moe_dispatch_sorted(x, w, tok,
                                                                 eid)),
                         max_abs_err=err))
    geos = launch_geometries(launched)
    flash = geos["flash"] if "flash" in only else []
    scans = geos["scan"] if "scan" in only else []
    emas = geos["ema"] if "ema" in only else []
    # flash and the scans draw from seeds of their own, so that a run that
    # times only some of the five sees the same data
    gen = torch.Generator(device="cuda").manual_seed(TIMING_SEED)
    for bh, sq, bg, sk, d in flash:
        q, k, v = flash_inputs(gen, 1, sq, sk, bh, bg, d, f32)
        want = attention_ref(q, k, v, causal=False)
        err = check_close("flash_attention", f"timing sq={sq} sk={sk} d={d}",
                          mha(q, k, v, causal=False), want, tol=ATTN_TOL,
                          show=False)
        rows.append(dict(kernel="flash_attention", case=f"sq={sq} sk={sk}",
                         geometry=dict(h=bh, g=bg, sq=sq, sk=sk, d=d),
                         dtype="float32",
                         ms=bench.ms(lambda: mha(q, k, v, causal=False)),
                         max_abs_err=err, **flash_plan(1, bh, sq, sk)))
    gen = torch.Generator(device="cuda").manual_seed(TIMING_SEED)
    for t, d, n, chunk in scans:
        x, dt, b, c = scan_inputs(gen, t, d, n, f32)
        want = ssm_chunked_ref(x, dt, b, c)
        err = check_close("ssm_chunked_scan", f"timing T={t} D={d} N={n}",
                          ssm_chunked_scan(x, dt, b, c, chunk=chunk), want,
                          tol=chunked_tol(f32, want), show=False)
        rows.append(dict(kernel="ssm_chunked_scan", case=f"T={t} D={d}",
                         geometry=dict(t=t, d=d, n=n, chunk=chunk),
                         dtype="float32",
                         ms=bench.ms(lambda: ssm_chunked_scan(x, dt, b, c,
                                                              chunk=chunk)),
                         max_abs_err=err, **scan_plan_of(t, d, n, 4)))
    gen = torch.Generator(device="cuda").manual_seed(TIMING_SEED)
    for t, d, chunk in emas:
        x, dt, g = ema_inputs(gen, t, d, f32)
        err = check_close("ssm_ema_scan", f"timing T={t} D={d}",
                          ssm_ema_scan(x, dt, g, chunk=chunk),
                          ssm_ema_ref(x, dt, g), exact=True, show=False)
        rows.append(dict(kernel="ssm_ema_scan", case=f"T={t} D={d}",
                         geometry=dict(t=t, d=d, chunk=chunk),
                         dtype="float32",
                         ms=bench.ms(lambda: ssm_ema_scan(x, dt, g,
                                                          chunk=chunk)),
                         max_abs_err=err, **ema_plan_of(t, d, 4)))
    for row in rows:
        say({"phase": "geometry-timing", **tags, **row, "card": smi})
    return rows


def check_moe_tiles(launched: list, gen, errs: dict[str, float]) -> None:
    """MoE dispatch's pre-pass on the card against ``plan.tile_list``, for
    tiles of both heights the kernels take, at every distinct main-path
    launch; then dispatches whose runs are 1, 7, 64, 127, 128 and 129 rows
    long, one row for each of 64 experts, and an unsorted ``eid``, in
    float32 and bf16 at F = 256 and 384, into outputs filled with NaN (a
    row no tile writes stays NaN and fails the check), against the plain
    version."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch_sorted_ref
    from repro_torch.kernels.moe_dispatch.kernel import (moe_grouped_gemm,
                                                         tile_list_on_card)
    from repro_torch.kernels.moe_dispatch.ops import launch_spec
    from repro_torch.kernels.moe_dispatch.plan import BM, SMALL_BM, tile_list

    def same_lists(tok, eid, n_exp, case) -> int:
        for bm in (SMALL_BM, BM):
            got = tile_list_on_card(tok, eid, n_exp, bm)
            want = tile_list(eid, bm)
            if not torch.equal(got, want):
                raise AssertionError(f"moe tile list {case}, bm {bm}: the "
                                     f"card's {got.tolist()} != "
                                     f"{want.tolist()}")
        return len(want)

    held, n_tiles = set(), 0
    for spec in launched:
        if spec.name != "moe_dispatch":
            continue
        tok, eid = spec.index
        n_exp = spec.operand("w").shape[0]
        key = (n_exp, tok.cpu().numpy().tobytes(), eid.cpu().numpy().tobytes())
        if key not in held:
            held.add(key)
            n_tiles += same_lists(tok, eid, n_exp, f"main path T={len(tok)}")
    say({"phase": "moe-tile-list", "distinct_launches": len(held),
         "tiles_at_128_rows": n_tiles, "ok": True})

    dev = torch.device("cuda")
    cases = {f"runs of {n}": [e for e in range(3) for _ in range(n)]
             for n in (1, 7, 64, 127, 128, 129)}
    cases["cold: 1 row each of 64 experts"] = list(range(64))
    cases["unsorted eid"] = torch.randint(0, 8, (300,), generator=gen,
                                          device=dev).tolist()
    d = 256
    for case, eid_list in cases.items():
        eid = torch.tensor(eid_list, dtype=torch.int32, device=dev)
        t, n_exp = len(eid_list), max(eid_list) + 1
        tok = torch.randperm(t, generator=gen, device=dev).to(torch.int32)
        n = same_lists(tok, eid, n_exp, case)
        # bf16 N-tiles of 256: F = 256 is one; F = 384 one and a last of 128
        for dtype, f in itertools.product((torch.float32, torch.bfloat16),
                                          (256, 384)):
            x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
            w = (torch.randn(n_exp, d, f, generator=gen, device=dev)
                 / d ** 0.5).to(dtype)
            out = torch.full((t, f), float("nan"), dtype=dtype, device=dev)
            got = moe_grouped_gemm(launch_spec(t, d, f, n_exp, tok, eid, dtype),
                                   x, w, tok, eid, out=out)
            want = moe_dispatch_sorted_ref(x.float(), w.float(), tok, eid)
            errs["moe_dispatch"] = max(errs["moe_dispatch"], check_close(
                "moe_dispatch", f"{case} ({n} tiles of <= 128 rows) T={t} "
                f"D={d} F={f}", got, want, tol=attn_tol(dtype, want)))


def grouped_mm_yardstick(bench: Bench, x, w, tok, eid, smi: str) -> None:
    """Time ``torch._grouped_mm`` (where the card's torch has it) on x
    already gathered into sorted order, with the experts' end offsets: a
    yardstick for the GEMM alone (no gather, no scatter), never called by
    the port.  Prints its time and its error against the plain version in
    sorted order, or why it is absent or refused."""
    fn = getattr(torch, "_grouped_mm", None)
    row = {"phase": "yardstick", "kernel": "moe_dispatch",
           "call": "torch._grouped_mm", "dtype": "bfloat16",
           "grouped_mm_ms": None, "card": smi}
    if fn is None:
        say({**row, "why": "absent from this torch"})
        return
    xs = x[tok.long()]
    offs = torch.bincount(eid.long(), minlength=w.shape[0]).cumsum(0).to(
        torch.int32)
    want = torch.cat([xs[a:b].float() @ w[e].float() for e, (a, b) in
                      enumerate(zip([0] + offs[:-1].tolist(), offs.tolist()))
                      if b > a])
    for form, wb in (("w as stored [E, D, F]", w),
                     ("w column-major", w.transpose(1, 2).contiguous()
                      .transpose(1, 2))):
        try:
            got = fn(xs, wb, offs=offs)
            torch.cuda.synchronize()
        except Exception as exc:   # refused: say why, try the other layout
            say({**row, "form": form, "why": f"{type(exc).__name__}: "
                 f"{str(exc)[:200]}"})
            continue
        say({**row, "form": form,
             "grouped_mm_ms": bench.ms(lambda: fn(xs, wb, offs=offs)),
             "max_abs_err": (got.float() - want).abs().max().item()})
        return


def forget_captures() -> None:
    """Drop the capture memo (one launch per geometry) and the serving
    window memo, so the next path launches its kernels as a fresh process
    does rather than reusing an earlier path's launches."""
    from repro_torch.capture import launch
    from repro_torch.serving import scenario

    launch._MEMO.clear()
    scenario._WINDOW_CACHE.clear()


def counted(K, drive) -> tuple[object, dict, float]:
    """Run ``drive()`` with every launch counter set to 0 just before it;
    returns its result, the counters read just after, and its seconds."""
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = drive()
    torch.cuda.synchronize()
    return out, K.launch_counts(), time.perf_counter() - t0


def sections_phase(K, registry, cpu_registry, roster, trace_dir: Path
                   ) -> tuple[dict, object, float]:
    """Main path 3: the roster with the scalability and energy sections on
    the card, traced; every kernel launched, 45/45, its first 12 columns
    phase 4's rows, all of it equal to the same roster on the CPU.
    Returns the launches, the table and the seconds."""
    from repro_torch.suite import SuiteRunner

    sections = ("scalability", "energy")

    def drive():
        forget_captures()
        return SuiteRunner(registry, store=None, sections=sections).roster()

    with obs_trace(trace_dir, "sections"):
        table, launches, secs = counted(K, drive)
    bad = [r for r in table.records() if not r["match"]]
    say({"phase": "sections", "sections": list(sections),
         "entries": len(table.rows), "matching": len(table.rows) - len(bad),
         "seconds": secs, "launches": launches})
    missing = [k for k, v in launches.items() if v <= 0 and k != SCAN_KERNEL]
    if len(table.rows) != 45 or bad or missing:
        raise AssertionError(f"sections: {len(table.rows)} rows, divergent "
                             f"{bad}, kernels not launched: {missing}")
    if [r[:12] for r in table.rows] != roster.rows:
        raise AssertionError("sections: the first 12 columns differ from "
                             "the plain roster's rows")
    t0 = time.perf_counter()
    cpu = SuiteRunner(cpu_registry, store=None, sections=sections).roster()
    if cpu.rows != table.rows:
        raise AssertionError("sections: rows on the card differ from the "
                             "CPU run's")
    say({"phase": "sections-vs-cpu", "identical": True,
         "cpu_seconds": time.perf_counter() - t0})
    return launches, table, secs


def serving_section_phase(K, timelines: dict) -> dict:
    """Main path 4: the serving roster through the suite runner on the
    card; flash, paged decode and MoE dispatch launched, 16 rows whose
    ``phase_timeline`` equals phase 5's timelines, rows equal to the CPU
    run's."""
    from repro_torch.suite import SuiteRunner, registry_for

    sections = ("serving",)

    def drive():
        forget_captures()
        return SuiteRunner(registry_for(sections=sections, device="cuda"),
                           store=None, sections=sections).roster()

    table, launches, secs = counted(K, drive)
    records = table.records()
    bad = [r for r in records if not r["match"]]
    say({"phase": "serving-section", "entries": len(records),
         "matching": len(records) - len(bad), "seconds": secs,
         "launches": launches,
         "mitigations": {r["name"]: [r["best_mitigation"], r["best_speedup"]]
                         for r in records}})
    missing = [k for k in ("flash_attention", "paged_kv_decode",
                           "moe_dispatch") if launches[k] <= 0]
    if len(records) != 16 or bad or missing:
        raise AssertionError(f"serving section: {len(records)} rows, "
                             f"divergent {bad}, not launched: {missing}")
    wrong = [r["name"] for r in records
             if r["phase_timeline"] != timelines[r["name"]].timeline()]
    if wrong:
        raise AssertionError(f"serving section: timelines differ from "
                             f"measure_windows' for {wrong}")
    t0 = time.perf_counter()
    cpu = SuiteRunner(registry_for(sections=sections, device="cpu"),
                      store=None, sections=sections).roster()
    if cpu.rows != table.rows:
        raise AssertionError("serving section: rows on the card differ from "
                             "the CPU run's")
    say({"phase": "serving-section-vs-cpu", "identical": True,
         "cpu_seconds": time.perf_counter() - t0})
    return launches


def store_pool_phase(K) -> dict:
    """Main path 5, at ``FAST_REFS``: a store that the CPU run filled is not
    recalled on the card; the card's first run computes 45 rows, a second
    runner recalls all 45 with no simulation; two worker processes give
    the sequential rows."""
    import tempfile

    from repro_torch import obs
    from repro_torch.suite import ResultStore, SuiteRunner, default_registry
    from repro_torch.suite.__main__ import FAST_REFS

    with tempfile.TemporaryDirectory() as tmp:
        store = ResultStore(Path(tmp) / "store")
        cpu = SuiteRunner(default_registry(refs=FAST_REFS, device="cpu"),
                          store=store)
        cpu_rows = cpu.roster().rows
        registry = default_registry(refs=FAST_REFS, device="cuda")

        def drive():
            forget_captures()
            first = SuiteRunner(registry, store=store)
            first.roster()
            obs.reset_counters()
            second = SuiteRunner(registry, store=store)
            second.roster()
            return first, second, obs.counters()

        (first, second, warm), launches, secs = counted(K, drive)
        say({"phase": "store", "refs": FAST_REFS, "seconds": secs,
             "cpu_run": cpu.stats.as_dict(),
             "card_first": first.stats.as_dict(),
             "card_second": second.stats.as_dict(),
             "card_second_engine": second.study.stats.as_dict(),
             "card_second_counters": warm, "launches": launches})
        if cpu.stats.computed != 45 or first.stats.recalled != 0 \
                or first.stats.computed != 45:
            raise AssertionError("store: a CPU-written record was recalled "
                                 "on the card, or the first run missed rows")
        if (second.stats.recalled != 45 or second.study.stats.sim_runs != 0
                or warm.get("store.recall.warm") != 45
                or warm.get("engine.sim.run", 0) != 0):
            raise AssertionError(f"store: the warm rerun simulated or did "
                                 f"not recall 45 rows: {warm}")
        rows = first.roster().rows
        if not rows == second.roster().rows == cpu_rows:
            raise AssertionError("store: rows differ between the first run, "
                                 "the recall and the CPU run")
        missing = [k for k, v in launches.items()
                   if v <= 0 and k != SCAN_KERNEL]
        if missing:
            raise AssertionError(f"store: the card run launched no "
                                 f"{missing}")

        def drive_pool():
            pool = SuiteRunner(registry, store=ResultStore(Path(tmp) / "pool"),
                               processes=2)
            # every entry goes to the workers: none falls back in-process
            if not all(pool._reconstructible(e) for e in registry):
                raise AssertionError("pool: an entry of the card registry "
                                     "is not rebuilt alike in a worker")
            return pool, pool.roster().rows

        (pool, pool_rows), pool_launches, pool_secs = counted(K, drive_pool)
        say({"phase": "pool", "processes": 2, "seconds": pool_secs,
             "stats": pool.stats.as_dict(),
             "launches_in_parent": pool_launches})
        if pool.stats.computed != 45 or pool_rows != rows:
            raise AssertionError("pool: two worker processes gave other rows "
                                 "than the sequential run")
    say({"phase": "store-pool-vs-sequential", "identical": True})
    return launches


# -- the simulator: spans, the window count and the cuda backend ------------

# Span names whose totals the span split prints, per path.
SPLIT_PREFIXES = ("sim.", "engine.", "capture.walk", "capture.sync",
                  "suite.", "serving.")
MEGAREF_REFS = 10_000_000   # simulate_chunked's megaref trace on the host
MEGAREF_PREFIX = 200_000    # ... and the prefix held against simulate


@contextlib.contextmanager
def obs_trace(trace_dir: Path, path: str):
    """Trace one main path into ``<trace_dir>/<path>.jsonl``, counters
    zeroed first, so its span split reads that path alone."""
    from repro_torch import obs

    obs.reset_counters()
    obs.enable(trace_dir / f"{path}.jsonl")
    try:
        yield
    finally:
        obs.disable()


def span_split(trace_dir: Path, path: str, smi: str):
    """Print one path's span split: seconds of simulation (``sim.many``
    and ``sim.chunked``, which hold every other ``sim.*`` span), trace
    generation (``engine.trace``, which holds the walk and the synchronize
    of a captured entry), the trace walk (``capture.walk``), the
    per-launch synchronize (``capture.sync``) and the entries
    (``suite.entry``); every span total and count and every counter."""
    from repro_torch.obs.report import aggregate

    rep = aggregate([trace_dir / f"{path}.jsonl"])
    row = {"phase": "span-split", "path": path, "wall_s": rep.wall_s,
           "simulation_s": rep.span_total("sim.many")
           + rep.span_total("sim.chunked"),
           "trace_s": rep.span_total("engine.trace"),
           "walk_s": rep.span_total("capture.walk"),
           "sync_s": rep.span_total("capture.sync"),
           "entry_s": rep.span_total("suite.entry"),
           "spans": {n: [st.count, st.total_s]
                     for n, st in sorted(rep.spans.items())
                     if n.startswith(SPLIT_PREFIXES)},
           "counters": rep.counters, "card": smi}
    say(row)
    return rep


def window_rows(gen, m: int, n_rows: int, chunk: int, dtype: torch.dtype):
    """Seeded q [m] (a set-local previous index or -1 for a cold slot) and
    [3, R] (lo, thr, span) rows on the card: ragged spans in [0, chunk + 3]
    (the kernel caps them at chunk), a quarter full, some windows ending at
    m - 1, some running past it."""
    dev = torch.device("cuda")

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    q = ints(-1, max(m // 4, 1), m)
    q[torch.rand(m, generator=gen, device=dev) < 0.2] = -1
    lo, span = ints(0, m, n_rows), ints(0, chunk + 4, n_rows)
    span[: n_rows // 4] = chunk
    k = n_rows // 8
    if k:
        lo[-k:] = (m - span[-k:]).clamp(min=0)
        lo[-2 * k:-k] = m - 1
    thr = ints(-2, max(m // 4, 1), n_rows)
    return q.to(dtype), torch.stack([lo, thr, span]).to(dtype).contiguous()


def window_ref(q, rows, chunk: int):
    """The plain version on the card, in row slices of at most 2^26
    gathered slots (its [R, chunk] index is int64)."""
    from repro_torch.kernels.window_scan import window_counts_ref

    step = max(1, (1 << 26) // max(int(chunk), 1))
    return torch.cat([window_counts_ref(q, rows[0, i:i + step],
                                        rows[1, i:i + step],
                                        rows[2, i:i + step], chunk)
                      for i in range(0, rows.shape[1], step)])


# Chunks that give the window count's plan every (lanes, steps) it picks:
# 1-4 one step of 1-4 lanes (3 is not a power of two), 8-32 four lanes in
# 2-8 steps (17 a ragged last step), 64-256 32 lanes in 2-8 steps, 1024
# the full-warp walk.
WINDOW_CHUNKS = (1, 2, 3, 4, 8, 16, 17, 32, 64, 128, 256, 1024)


def window_scan_seeded(gen, errs: dict[str, float]) -> None:
    """Phase 2's window-count check: seeded rows, int32 and int64 q,
    exact against the plain version, at every (lanes, steps) of the plan
    with a ragged last tile (50 000 + chunk rows), and at a few wide,
    narrow and tiny geometries."""
    from repro_torch.kernels.window_scan import window_count_cuda
    from repro_torch.kernels.window_scan.kernel import launch_plan

    cases = [(1 << 20, 50_000 + c, c) for c in WINDOW_CHUNKS]
    cases += [(1 << 22, (1 << 16) + 5, 16), (1 << 22, 4096, 1024),
              (5_000, 300, 8), (40, 33, 64), (1, 5, 8)]
    for dtype in (torch.int32, torch.int64):
        for m, n_rows, chunk in cases:
            q, rows = window_rows(gen, m, n_rows, chunk, dtype)
            plan = launch_plan(q, n_rows, chunk)
            errs[SCAN_KERNEL] = max(errs[SCAN_KERNEL], check_close(
                SCAN_KERNEL, f"seeded m={m} rows={n_rows} chunk={chunk} "
                f"lanes={plan['lanes']} steps={plan['steps']} "
                f"tile={plan['rows_per_tile']}",
                window_count_cuda(q, rows, chunk), window_ref(q, rows, chunk),
                exact=True))


def roster_run(K, registry, path: str, sections: tuple, backend: str,
               want_rows, trace_dir: Path, smi: str, *, record: bool
               ) -> tuple[dict, list, float, object]:
    """One run of ``SuiteRunner.roster()`` (capture memos dropped first),
    traced, counters set to 0 before and read after: 45/45 and rows equal
    to ``want_rows``; under ``backend="cuda"`` also ``scan.cuda`` > 0 and
    window-count launches > 0.  Returns the launches, every window count
    made (when ``record``), the seconds and the span split."""
    from repro_torch.kernels import window_scan
    from repro_torch.suite import SuiteRunner

    def drive():
        forget_captures()
        return SuiteRunner(registry, store=None, sections=sections,
                           backend=backend).roster()

    with obs_trace(trace_dir, path), contextlib.ExitStack() as stack:
        calls = stack.enter_context(window_scan.record()) if record else []
        table, launches, secs = counted(K, drive)
    rep = span_split(trace_dir, path, smi)
    bad = [r for r in table.records() if not r["match"]]
    say({"phase": f"{path}-backend", "backend": backend,
         "entries": len(table.rows), "matching": len(table.rows) - len(bad),
         "seconds": secs, "sim_scan_s": rep.span_total("sim.scan"),
         "scan_cuda": rep.counter("scan.cuda"),
         "window_counts": launches[SCAN_KERNEL], "launches": launches,
         "card": smi})
    if len(table.rows) != 45 or bad:
        raise AssertionError(f"{path}: {len(bad)} divergent")
    if table.rows != want_rows:
        raise AssertionError(f"{path}: rows under backend={backend!r} differ "
                             f"from the vectorized backend's")
    if backend == "cuda" and (rep.counter("scan.cuda") <= 0
                              or launches[SCAN_KERNEL] <= 0):
        raise AssertionError(f"{path}: the cuda backend launched no window "
                             f"count")
    missing = [k for k, v in launches.items() if v <= 0 and k != SCAN_KERNEL]
    if missing:
        raise AssertionError(f"{path} launched no {missing}")
    return launches, calls, secs, rep


def roster_turns(K, registry, want_rows, trace_dir: Path, smi: str
                 ) -> tuple[dict, list]:
    """Main path 6: ``roster()`` with the vectorized and the cuda backend
    in turns (vectorized, cuda, cuda, vectorized), each traced with its
    span split; prints each side's seconds and ``sim.scan`` seconds.
    Returns the first cuda run's launches and its window counts."""
    secs: dict[str, list[float]] = {"vectorized": [], "cuda": []}
    scan_s: dict[str, list[float]] = {"vectorized": [], "cuda": []}
    first = None
    for turn, backend in enumerate(("vectorized", "cuda", "cuda",
                                    "vectorized")):
        launches, calls, t, rep = roster_run(
            K, registry, f"roster-{backend}-{turn}", (), backend, want_rows,
            trace_dir, smi, record=backend == "cuda" and first is None)
        secs[backend].append(t)
        scan_s[backend].append(rep.span_total("sim.scan"))
        if backend == "cuda" and first is None:
            first = (launches, calls)
    say({"phase": "roster-turns", "order": "vectorized, cuda, cuda, "
         "vectorized", "seconds": secs, "sim_scan_s": scan_s,
         "cuda_over_vectorized": sum(secs["cuda"]) / sum(secs["vectorized"]),
         "card": smi})
    return first


def window_traffic(q, rows, chunk: int) -> dict:
    """The q slots the rows' windows read, each window capped at chunk
    and clipped at m (a window running past m - 1 reads slot m - 1):
    ``slots`` counts each slot once (the union of the windows),
    ``slots_per_window`` once a window; ``sectors`` and
    ``sectors_per_window`` the same in 32-byte sectors of q."""
    m, isz = q.numel(), q.element_size()
    n = rows[2].long().clamp(min=0, max=chunk)
    lo = rows[0].long()[n > 0]
    end = torch.clamp(lo + n[n > 0], max=m)

    def union(a, b, size: int) -> int:
        edge = torch.zeros(size + 1, dtype=torch.int32, device=q.device)
        one = torch.ones_like(a, dtype=torch.int32)
        edge.index_add_(0, a, one)
        edge.index_add_(0, b, -one)
        return int((edge.cumsum(0)[:size] > 0).sum().item())

    s_lo, s_hi = lo * isz // 32, (end - 1) * isz // 32 + 1
    n_sectors = -(-m * isz // 32)
    return {"slots": union(lo, end, m),
            "slots_per_window": int((end - lo).sum().item()),
            "sectors": union(s_lo, s_hi, n_sectors),
            "sectors_per_window": int((s_hi - s_lo).sum().item())}


def window_bound(q, rows, chunk: int) -> tuple:
    """The window count's bound: each q slot some window reads, read once,
    plus each row's lo, thr, span and count, over the memory rate (its
    compares, one a window slot, over the f32 rate, are far below).
    Returns (bytes, ops, traffic)."""
    traffic = window_traffic(q, rows, chunk)
    nbytes = (traffic["slots"] + 4 * rows.shape[1]) * q.element_size()
    return nbytes, traffic["slots_per_window"], traffic


def distinct_window_calls(calls: list) -> dict[tuple[int, int], tuple]:
    """The first (q, rows, chunk) of each distinct (rows, chunk)."""
    distinct: dict[tuple[int, int], tuple] = {}
    for q, rows, chunk in calls:
        distinct.setdefault((rows.shape[1], chunk), (q, rows, chunk))
    return distinct


def largest_window_calls(calls: list, n: int = 3) -> list:
    """The ``n`` distinct (rows, chunk) of ``calls`` with the most rows x
    chunk, each with its own (q, rows, chunk)."""
    return sorted(distinct_window_calls(calls).items(),
                  key=lambda kv: kv[0][0] * kv[0][1], reverse=True)[:n]


def window_scan_main_path(calls: list, smi: str, peaks: dict,
                          errs: dict[str, float]) -> dict:
    """The window count at every distinct (rows, chunk) the cuda paths
    recorded, on each one's own q and rows, exact against the plain
    version; then the three largest (rows x chunk) timed, beside the plain
    version, the same PyTorch expression as the library yardstick, and the
    bound (:func:`window_bound`), with the slots and sectors the windows
    read.  Returns the largest geometry's timing row."""
    from repro_torch.kernels.window_scan import window_count_cuda
    from repro_torch.kernels.window_scan.kernel import launch_plan

    distinct = distinct_window_calls(calls)
    t0 = time.perf_counter()
    worst = 0.0
    for (n_rows, chunk), (q, rows, _) in distinct.items():
        worst = max(worst, check_close(
            SCAN_KERNEL, f"main path rows={n_rows} chunk={chunk}",
            window_count_cuda(q, rows, chunk), window_ref(q, rows, chunk),
            exact=True, show=False))
    errs[SCAN_KERNEL] = max(errs[SCAN_KERNEL], worst)
    say({"phase": "main-path-parity-kernel", "kernel": SCAN_KERNEL,
         "distinct_launches": len(distinct), "max_abs_err": worst,
         "tolerance": "exact", "seconds": time.perf_counter() - t0,
         "geometries": sorted(distinct), "ok": True})

    bench = Bench(peaks)
    first = None
    for (n_rows, chunk), (q, rows, _) in largest_window_calls(calls):
        nbytes, ops, traffic = window_bound(q, rows, chunk)
        row = timing_row(
            bench, smi, SCAN_KERNEL, f"rows={n_rows} chunk={chunk} "
            f"m={q.numel()}", q.dtype,
            bench.ms(lambda: window_count_cuda(q, rows, chunk)),
            bench.ms(lambda: window_ref(q, rows, chunk)),
            bench.ms(lambda: window_ref(q, rows, chunk)),
            nbytes, ops, "f32", **traffic,
            plan=launch_plan(q, n_rows, chunk))
        first = first or row
    del bench
    torch.cuda.empty_cache()
    return first


def megaref_trace(n: int, seed: int = 0):
    """The reference tests' megaref word stream (``_megaref_trace`` of
    ``tests/test_cachesim_seg_stream.py``): strided sweeps over a bounded
    footprint with a hot reuse set."""
    import numpy as np

    rng = np.random.default_rng(seed)
    footprint = 1 << 19
    sweep = (np.arange(n, dtype=np.int64) * 3) % footprint
    hot = rng.integers(0, 4_096, n, dtype=np.int64)
    pick = rng.random(n) < 0.3
    return np.where(pick, hot, sweep) * 8


def sim_counts(sim) -> tuple:
    return (sim.level_hits, sim.level_misses, sim.lines_touched,
            sim.prefetch_issued, sim.prefetch_useful, sim.accesses)


def megaref_phase(K, smi: str) -> None:
    """``simulate_chunked`` over the megaref trace at ``MEGAREF_REFS``,
    with the NumPy scan and with ``scan="cuda"``: equal counters; and on a
    ``MEGAREF_PREFIX`` prefix both equal the in-memory ``simulate``."""
    from repro_torch import obs
    from repro_torch.core import cachesim
    from repro_torch.core.cachesim_stream import simulate_chunked

    addr = megaref_trace(MEGAREF_REFS)
    cfg = cachesim.host_config(4)
    runs = {}
    for scan in (None, "cuda"):
        obs.reset_counters()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        sim = simulate_chunked(addr, cfg, chunk=1 << 18,
                               spill_bytes=8 * 2**20, scan=scan)
        secs = time.perf_counter() - t0
        c = obs.counters()
        runs[scan or "numpy"] = sim
        say({"phase": "megaref-chunked", "refs": MEGAREF_REFS,
             "scan": scan or "numpy", "seconds": secs,
             "counters": sim_counts(sim), "obs": c,
             "window_counts": K.launch_counts()[SCAN_KERNEL], "card": smi})
        if scan == "cuda" and (c.get("scan.cuda", 0) <= 0
                               or K.launch_counts()[SCAN_KERNEL] <= 0):
            raise AssertionError("megaref: scan='cuda' launched no window "
                                 "count")
    if sim_counts(runs["numpy"]) != sim_counts(runs["cuda"]) \
            or runs["numpy"].accesses != MEGAREF_REFS:
        raise AssertionError("megaref: scan='cuda' counters differ from the "
                             "NumPy scan's")
    prefix = addr[:MEGAREF_PREFIX]
    want = sim_counts(cachesim.simulate(prefix.copy(), cfg,
                                        backend="vectorized"))
    got = {scan or "numpy": sim_counts(simulate_chunked(
        prefix.copy(), cfg, chunk=1 << 14, scan=scan))
        for scan in (None, "cuda")}
    say({"phase": "megaref-prefix", "refs": MEGAREF_PREFIX,
         "in_memory": want, "chunked": got})
    if any(v != want for v in got.values()):
        raise AssertionError("megaref prefix: simulate_chunked differs from "
                             "the in-memory simulate")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import tempfile

    import repro_torch

    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError(f"repro_torch imported from outside {ROOT}")
    from repro_torch import kernels as K
    from repro_torch.capture.launch import record as record_launches
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_ref, mha
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention as flash_kernel)
    from repro_torch.kernels.ssm_scan import ssm_ema_ref, ssm_ema_scan
    from repro_torch.kernels.ssm_scan.ops import scan_flops
    from repro_torch.kernels.stream import ops as stream_ops
    from repro_torch.kernels.stream.kernel import stream_cuda
    from repro_torch.kernels.token_gather import gather, gather_rows_ref
    from repro_torch.serving import SCENARIOS, measure_windows
    from repro_torch.suite import SuiteRunner, default_registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(smi)
    name = torch.cuda.get_device_name(0)
    say({"torch": torch.__version__, "cuda": torch.version.cuda,
         "device": name})
    peaks = card_peaks(name)

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build(list(K.KERNELS))
    say({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
         "built": sorted(logs)})
    for kname, log in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                say(f"# ptxas {kname}: {line.strip()}")
    for lib, fn_part in NO_SPILL.items():
        spilled = {fn: n for fn, n in ptxas_spills(logs.get(lib, "")).items()
                   if fn_part in fn}
        say({"phase": "spills", "library": lib, "function": fn_part,
             "bytes": spilled})
        if any(spilled.values()):
            raise AssertionError(f"{fn_part} spills: {spilled}")
    for lib, fn_name in (("flash_attention", "flash_fwd_sm90"),
                         ("moe_dispatch", "moe_gemm_sm90")):
        sass = sass_counts(_build.library_path(lib))
        for fn, counts in sass.items():
            say({"phase": "sass", "library": lib, "function": fn, **counts})
        if not sum(c["HGMMA"] for fn, c in sass.items() if fn_name in fn):
            raise AssertionError(f"{fn_name} holds no HGMMA (wgmma) "
                                 f"instruction")

    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-obs-")
    trace_dir = Path(tmp.name)      # one span/counter trace per main path
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs: dict[str, float] = dict.fromkeys(K.KERNELS, 0.0)
    rows: dict[tuple[str, torch.dtype], dict] = {}   # timing rows
    bench = Bench(peaks)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    def record(*args, **kw) -> dict:
        return timing_row(bench, smi, *args, **kw)

    # -- 2+3. STREAM ------------------------------------------------------------
    # In turns: the library call and the kernel, both writing into one
    # preallocated output, and the entry point, which allocates its output
    # as a user's call does.  ``ms`` is the kernel's; ``entry_ms`` the entry
    # point's.
    streams = stream_calls()
    q = 3.0
    n = 2**28
    for dtype in (torch.float32, torch.bfloat16):
        a, b = randn(n, dtype=dtype), randn(n, dtype=dtype)
        o = torch.empty_like(a)
        for op, (entry, plain, lib) in streams.items():
            spec = stream_ops.launch_spec(op, n, dtype)
            want = plain(a, b, q)
            check_close("stream", f"{op} full n=2^28 entry point",
                        entry(a, b, q), want, exact=True)
            check_close("stream", f"{op} full n=2^28 into out",
                        stream_cuda(spec, op, a, b, q, out=o), want,
                        exact=True)
            del want
            ms = bench.turns(
                [("library", lambda: lib(a, b, q, o)),
                 ("kernel", lambda: stream_cuda(spec, op, a, b, q, out=o)),
                 ("entry", lambda: entry(a, b, q)),
                 ("library", lambda: lib(a, b, q, o))], STREAM_ROUNDS)
            row = record(
                "stream", op, dtype, ms["kernel"],
                bench.ms(lambda: plain(a, b, q)), ms["library"],
                stream_ops.bytes_moved(op, n, a.element_size()),
                stream_ops.STREAM_OPS[op][1] * n, "f32",
                entry_ms=ms["entry"], vs_library=ms["kernel"] / ms["library"])
            if op == "triad":
                rows["stream", dtype] = row
        del a, b, o
    torch.cuda.empty_cache()

    # -- 2+3. token gather ----------------------------------------------------
    def gather_idx(n_rows: int, m: int):
        idx = torch.randint(0, n_rows, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[:3] = torch.tensor([0, n_rows - 1, 0], dtype=torch.int32)
        return idx

    n_rows, d, m = 152064, 5120, 8192
    for dtype in (torch.float32, torch.bfloat16):
        table, idx = randn(n_rows, d, dtype=dtype), gather_idx(n_rows, m)
        errs["token_gather"] = max(errs["token_gather"], check_close(
            "token_gather", f"full {n_rows}x{d} m={m}",
            gather(table, idx), gather_rows_ref(table, idx), exact=True))
        row = record(
            "token_gather", f"{n_rows}x{d} m={m}", dtype,
            bench.ms(lambda: gather(table, idx)),
            bench.ms(lambda: gather_rows_ref(table, idx)),
            bench.ms(lambda: torch.index_select(table, 0, idx)),
            2 * m * d * table.element_size() + 4 * m, 0.0, "f32")
        rows["token_gather", dtype] = row
        del table, idx
    torch.cuda.empty_cache()

    # -- 2+3. flash attention (the same timings as scripts/kernel_ab.py) ----
    for dtype, d in ((torch.float32, 128), (torch.bfloat16, 128),
                     (torch.bfloat16, 64)):
        for causal in (True, False):
            row, err = flash_full_width(bench, smi, dtype, d, causal)
            errs["flash_attention"] = max(errs["flash_attention"], err)
            if row is not None and causal:
                rows["flash_attention", dtype] = row
        torch.cuda.empty_cache()
    # f32 launches the plan cuts into several kv ranges, causal, so that the
    # first q tiles' later ranges lie wholly above the diagonal.
    for bsz, s, h, g, d in ((1, 1024, 2, 1, 128), (2, 512, 4, 2, 64)):
        qq, kk, vv = flash_inputs(gen, bsz, s, s, h, g, d, torch.float32)
        plan = flash_plan(bsz, h, s, s)
        if plan["n_splits"] < 2:
            raise AssertionError(f"flash plan gave one split at {plan}")
        errs["flash_attention"] = max(errs["flash_attention"], check_close(
            "flash_attention", f"split b={bsz} s={s} h={h} g={g} d={d} "
            f"causal=True {plan}", mha(qq, kk, vv, causal=True),
            attention_ref(qq, kk, vv, causal=True), tol=ATTN_TOL))

    # -- 2+3. paged-KV decode and MoE dispatch (the same timings as
    # scripts/kernel_ab.py) ------------------------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        row, err = paged_full_width(
            bench, smi, dtype,
            n_splits=paged_splits(FULL_PAGED, 4 if dtype == torch.float32
                                  else 2))
        rows["paged_kv_decode", dtype] = row
        errs["paged_kv_decode"] = max(errs["paged_kv_decode"], err)
        row, err = moe_full_width(bench, smi, dtype)
        rows["moe_dispatch", dtype] = row
        errs["moe_dispatch"] = max(errs["moe_dispatch"], err)
        torch.cuda.empty_cache()

    # -- 2+3. SSM scans: one Zamba2-7B Mamba-2 layer (the chunked scan's
    # timings are scripts/kernel_ab.py's) -----------------------------------
    t, d, n, chunk = (FULL_SCAN[k] for k in ("t", "d", "n", "chunk"))
    direct_ops = 5.0 * n * d * t
    closed_ops = scan_flops("expand", seq_len=t, d=d, n=n, chunk=chunk)
    say({"phase": "ssm-chunked-ops", "direct_recurrence": direct_ops,
         "closed_form_scan_flops": closed_ops,
         "sets_the_bound": "direct" if direct_ops <= closed_ops else "closed"})
    for dtype in (torch.float32, torch.bfloat16):
        row, err = ema_full_width(bench, smi, dtype)
        rows["ssm_ema_scan", dtype] = row
        errs["ssm_ema_scan"] = max(errs["ssm_ema_scan"], err)
        # a sequence whose last ring stage is cut short (T 1000, stages of
        # 64 steps: TMA reads the box's rows past T as zeros)
        x, dt, g = ema_inputs(gen, 1000, 256, dtype)
        want = ssm_ema_ref(x.float(), dt.float(), g.float())
        errs["ssm_ema_scan"] = max(errs["ssm_ema_scan"], check_close(
            "ssm_ema_scan", f"short last stage T=1000 D=256 "
            f"{ema_plan_of(1000, 256, x.element_size())}",
            ssm_ema_scan(x, dt, g, chunk=40), want, **ema_tol(dtype, want)))
        row, err = chunked_full_width(bench, smi, dtype)
        rows["ssm_chunked_scan", dtype] = row
        errs["ssm_chunked_scan"] = max(errs["ssm_chunked_scan"], err)
    del bench
    torch.cuda.empty_cache()

    # -- 2. the simulator's window count on seeded rows (timed in phase 14,
    # at the geometries the cuda backend's main paths give it) -------------
    window_scan_seeded(gen, errs)
    torch.cuda.empty_cache()

    # -- 4. main path 1: the 45-entry roster on the card -----------------------
    # Driven entry by entry (``row``, what ``roster`` runs after one batch of
    # the same cells) to time each source; ``roster`` then only reads.
    K.reset_launch_counts()
    t0 = time.perf_counter()
    by_source = {"synthetic": 0.0, "captured": 0.0}
    with obs_trace(trace_dir, "roster"), record_launches() as launched:
        registry = default_registry(device="cuda")
        registry_s = time.perf_counter() - t0
        runner = SuiteRunner(registry, store=None)
        for entry in registry:
            t1 = time.perf_counter()
            runner.row(entry)
            torch.cuda.synchronize()
            by_source[entry.source] += time.perf_counter() - t1
        roster = runner.roster()
        torch.cuda.synchronize()
    roster_launches = K.launch_counts()
    roster_flash = dict(flash_kernel.launches_by_kernel)
    roster_s = time.perf_counter() - t0
    bad = [r for r in roster.records() if not r["match"]]
    say({"phase": "roster", "entries": len(roster.rows),
         "matching": len(roster.rows) - len(bad), "seconds": roster_s,
         "registry_seconds": registry_s, "seconds_by_source": by_source,
         "engine": runner.study.stats.as_dict(),
         "launches": roster_launches, "flash_launches_by_kernel": roster_flash})
    for rec in roster.records():
        say({"phase": "roster-row", **rec})
    if len(roster.rows) != 45 or bad:
        raise AssertionError(f"roster: {len(bad)} divergent entries: {bad}")
    missing = [k for k, v in roster_launches.items()
               if v <= 0 and k != SCAN_KERNEL]
    if missing:
        raise AssertionError(f"kernels not launched by the roster: {missing}")
    if len(launched) != sum(roster_launches.values()):
        raise AssertionError(f"{len(launched)} launch specs recorded for "
                             f"{sum(roster_launches.values())} kernel launches")
    t0 = time.perf_counter()
    cpu_registry = default_registry(device="cpu")
    cpu_rows = SuiteRunner(cpu_registry, store=None).roster().rows
    if cpu_rows != roster.rows:
        raise AssertionError("roster rows on the card differ from the rows "
                             "of the plain versions on the CPU")
    say({"phase": "roster-vs-cpu", "identical": True,
         "cpu_seconds": time.perf_counter() - t0})
    split = span_split(trace_dir, "roster", smi)
    if not 0 < split.counter("profile.scan") <= split.counter("profile.geom"):
        raise AssertionError("cold roster: profile.scan is not within "
                             "(0, profile.geom]")

    # -- 5. main path 2: the serving roster on the card ------------------------
    K.reset_launch_counts()
    t0 = time.perf_counter()
    timelines = {}
    with obs_trace(trace_dir, "serving"), record_launches() as served:
        for scen in SCENARIOS:
            t1, before = time.perf_counter(), K.launch_counts()
            tl = timelines[scen] = measure_windows(scen, device="cuda")
            torch.cuda.synchronize()
            after = K.launch_counts()
            say({"phase": "serving-scenario", "scenario": scen,
                 "timeline": tl.timeline(), "whole_label": tl.whole_label,
                 "seconds": time.perf_counter() - t1,
                 "launches": {k: after[k] - before[k] for k in after
                              if after[k] > before[k]}})
    serving_launches = K.launch_counts()
    serving_flash = dict(flash_kernel.launches_by_kernel)
    serving_s = time.perf_counter() - t0
    say({"phase": "serving", "scenarios": len(timelines),
         "seconds": serving_s, "launches": serving_launches,
         "flash_launches_by_kernel": serving_flash})
    missing = [k for k in ("flash_attention", "paged_kv_decode",
                           "moe_dispatch") if serving_launches[k] <= 0]
    if len(timelines) != 16 or missing:
        raise AssertionError(f"serving: {len(timelines)} scenarios, kernels "
                             f"not launched: {missing}")
    if len(served) != sum(serving_launches.values()):
        raise AssertionError(f"{len(served)} launch specs recorded for "
                             f"{sum(serving_launches.values())} kernel "
                             f"launches")
    t0 = time.perf_counter()
    for scen, tl in timelines.items():
        ref = measure_windows(scen, device="cpu")
        same = (tl.labels == ref.labels and tl.whole_label == ref.whole_label
                and all(a.addresses.tobytes() == b.addresses.tobytes()
                        and (a.raw_refs, a.flops, a.batch)
                        == (b.raw_refs, b.flops, b.batch)
                        for a, b in zip(tl.windows, ref.windows)))
        if not same:
            raise AssertionError(f"serving {scen}: windows or labels on the "
                                 f"card differ from the CPU run's")
    say({"phase": "serving-vs-cpu", "identical": True,
         "cpu_seconds": time.perf_counter() - t0})
    span_split(trace_dir, "serving", smi)

    # -- 6. parity at every distinct launch of both paths -----------------------
    t0 = time.perf_counter()
    held = hold_main_path(launched + served, randn, rand, errs)
    say({"phase": "main-path-parity",
         "launches": len(launched) + len(served), "distinct": held,
         "seconds": time.perf_counter() - t0})
    check_reference_tiles(randn, errs)

    # -- 7. MoE dispatch's tile list, ragged tiles, unsorted eid --------------
    check_moe_tiles(launched + served, gen, errs)

    # -- 8. paged decode and MoE dispatch at the main paths' geometries ------
    for case, geo in main_path_geometries()[0]:
        say({"phase": "paged-splits", "case": case, "geometry": geo,
             "n_splits": paged_splits(geo, 4)})
    geometry_timings(Bench(peaks), smi, launched + served)
    torch.cuda.empty_cache()

    # -- 9. out-of-range indices -------------------------------------------------
    check_bad_index()

    # -- 10-12. the sections, the serving section, the store and the pool ------
    sections_launches, sections_table, sections_s = sections_phase(
        K, registry, cpu_registry, roster, trace_dir)
    span_split(trace_dir, "sections", smi)
    serving_section_launches = serving_section_phase(K, timelines)
    store_pool_phase(K)

    # -- 13. main paths 6-7: roster() with the vectorized and the cuda
    # backend in turns, then the sections with backend="cuda" -------------
    roster_cuda_launches, roster_calls = roster_turns(
        K, registry, roster.rows, trace_dir, smi)
    sections_cuda_launches, sections_calls, secs, _ = roster_run(
        K, registry, "sections-cuda", ("scalability", "energy"), "cuda",
        sections_table.rows, trace_dir, smi, record=True)
    say({"phase": "sections-cuda-vs-vectorized", "cuda_seconds": secs,
         "vectorized_seconds": sections_s, "card": smi})

    # -- 14. the window count at every distinct main-path geometry ---------
    rows[SCAN_KERNEL, torch.int32] = window_scan_main_path(
        roster_calls + sections_calls, smi, peaks, errs)
    del roster_calls, sections_calls
    torch.cuda.empty_cache()

    # -- 15. simulate_chunked over a megaref trace on the card's host -------
    megaref_phase(K, smi)

    # -- 16. results --------------------------------------------------------
    kernels = []
    for kname, (source, replaces) in KERNEL_SITES.items():
        scan = kname == SCAN_KERNEL
        r = rows[kname, torch.int32 if scan else torch.float32]
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (roster_cuda_launches[kname] if scan else
                         roster_launches[kname] + serving_launches[kname]),
            "launches_by_path": {
                "roster": roster_launches[kname],
                "serving": serving_launches[kname],
                "sections": sections_launches[kname],
                "serving_section": serving_section_launches[kname],
                "roster_cuda": roster_cuda_launches[kname],
                "sections_cuda": sections_cuda_launches[kname]},
            "max_abs_err": errs[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        if not scan:
            r16 = rows[kname, torch.bfloat16]
            entry.update(bf16_ms=r16["ms"], bf16_bound_ms=r16["bound_ms"],
                         bf16_library_ms=r16["library_ms"])
        if kname == "flash_attention":
            entry["launches_by_kernel"] = {
                k: roster_flash[k] + serving_flash[k] for k in roster_flash}
        kernels.append(entry)
    say({"kernels": kernels})
    tmp.cleanup()
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
