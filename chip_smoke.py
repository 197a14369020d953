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
   flash or bf16 MoE dispatch has no ``HGMMA``, or if the f32 flash kernel
   or the state-expanded scan spills;
2. holds each kernel against its plain PyTorch version on the card at
   full width, in float32 and bf16: qwen2.5-14b for STREAM, gather, flash
   and paged decode (40 query heads, 8 KV heads, head_dim 128, vocab
   152064; bf16 flash also at head_dim 64); one DeepSeek-MoE-16B layer's
   routed dispatch (4096 tokens, top-6 of 64 experts, d_model 2048,
   d_ff_expert 1408); one Zamba2-7B Mamba-2 layer's scans (T 4096, d_inner
   7168, ssm_state 64, chunk 128); f32 flash also on two causal launches
   its plan cuts into several kv ranges, some wholly above the diagonal;
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
   split count, the state-expanded scan its plan and its issue floor (4 N
   D T f32 lane-instructions, the update's multiplies and adds unfused);
   bf16 MoE dispatch prints, where the card's torch has it,
   ``torch._grouped_mm`` on x already gathered into sorted order as
   ``grouped_mm_ms`` (a yardstick for the GEMM alone).  Paged decode, MoE
   dispatch, flash and the state-expanded scan draw their inputs from a
   seed of their own, here and in phase 8, and ``scripts/kernel_ab.py``
   times another checkout's kernels through the same functions on the same
   data;
4. main path 1: sets every launch counter to 0, runs the 24-entry
   captured roster (``repro_torch.suite``) on the card recording every
   launch's spec, reads the counters, checks 24/24 classes as expected,
   all seven kernels launched, and rows equal to the roster run on the CPU;
5. main path 2: sets the counters to 0 again, runs ``measure_windows``
   for the 16 serving scenarios (``repro_torch.serving``) on the card,
   reads the counters, checks that flash attention, paged decode and MoE
   dispatch launched, and that every scenario's window traces, timeline
   and whole-trace label equal the same run on the CPU;
6. holds each kernel against its plain version again at every distinct
   launch of both paths: its shapes and tiles, with its own index vectors
   (gather rows; page table, also reversed; MoE token order and expert
   ids) and, for the scans, its chunk; every flash shape also recast to
   bf16 at head_dim 64 and 128, causal and not;
7. MoE dispatch's tile list: the pre-pass run alone on the card at every
   distinct main-path MoE launch equals ``plan.tile_list``; dispatches
   with an unsorted ``eid`` and with runs of 1, 7, 64, 127, 128 and 129
   rows (f32 and bf16, into outputs filled with NaN) match the plain
   version;
8. prints paged decode's split count at each main-path geometry, and
   times paged decode and MoE dispatch at the main paths' geometries (the
   captured roster's four of each and the serving roster's one), flash
   attention at every distinct flash launch of both paths (with its kv
   split) and the state-expanded scan at every distinct launch of the
   roster's (with its plan), in float32, each checked against the plain
   version first;
9. checks, in child processes, that an out-of-range gather index, page
   or MoE expert id makes the launch fail rather than read past the table;
10. prints the kernels line (``launches`` summed over both paths, flash's
   also split by kernel; the f32 timings, and the bf16 ones as
   ``bf16_ms``, ``bf16_bound_ms``, ``bf16_library_ms``) and, last,
   ``{"ok": true, "device": ...}``.

Tolerances: gather is exact.  STREAM's plain version rounds op by op as
the kernel does, so both dtypes are held to the float32 tolerance of the
CPU tests (rtol 1e-5, atol 1e-6); so is the EMA scan in float32, which
rounds op by op in the plain version's order.  Attention, paged decode
and MoE dispatch in float32: rtol 1e-4, atol 2e-5 (MoE's is the
reference's).  The state-expanded scan in float32: rtol 1e-4 and atol
1e-4 of the output's rms; its state is rounded as the plain version's,
but y_t's sum over the N state rows is taken in another order, whose
error is at most N 2^-24 sum|c h|, about 3e-5 of the rms at N = 64.  In
bf16 every kernel but STREAM is held against the plain version computed
in float32 on the same bf16 inputs (the kernels compute in float32, bf16
flash's P.V on two bf16 halves of P, and round once): rtol 1e-2, 2.5x the
bf16 rounding of a value (2^-8), and atol 1e-3 of the output's rms.

It exits non-zero without a result when no CUDA device is available, and
when run outside a checkout (it imports the package from ``src/`` beside
itself).
"""

from __future__ import annotations

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
}


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
STREAM_TOL = (1e-5, 1e-6)   # (rtol, atol), both dtypes; EMA scan f32
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
            "ssm_chunked_scan": "ssm_chunked_kernel"}


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
                      want, tol=attn_tol(dtype, want, STREAM_TOL))
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
    """The launch specs of both main paths (the captured roster, then the 16
    serving scenarios) run on ``device``."""
    from repro_torch.capture.launch import record
    from repro_torch.serving import SCENARIOS, measure_windows
    from repro_torch.suite.runner import SuiteRunner

    with record() as launched:
        SuiteRunner(device=device).roster()
        for scen in SCENARIOS:
            measure_windows(scen, device=device)
    return launched


def flash_scan_geometries(launched: list) -> tuple[list, list]:
    """The distinct flash (``(bh, sq, bg, sk, d)``) and state-expanded scan
    (``(t, d, n, chunk)``) launches among ``launched``, in launch order."""
    flash, scans = {}, {}
    for spec in launched:
        if spec.name == "flash_attention":
            bh, sq, d = spec.operand("q").shape
            bg, sk, _ = spec.operand("k").shape
            flash[(bh, sq, bg, sk, d)] = None
        elif spec.name == "ssm_expand":
            t, d = spec.operand("x").shape
            scans[(t, d, spec.operand("b").shape[1],
                   spec.operand("x").block_shape[0])] = None
    return list(flash), list(scans)


GEOMETRY_KERNELS = ("paged", "moe", "flash", "scan")


def geometry_timings(bench: Bench, smi: str, launched: list,
                     only=GEOMETRY_KERNELS, **tags) -> list[dict]:
    """Time paged decode and MoE dispatch at the main paths' geometries,
    and flash attention and the state-expanded scan at every distinct
    launch of theirs among ``launched``, through the entry points in
    float32, each first held against its plain version (``only`` names
    which of the four); prints one row each (with ``tags``) and returns
    them."""
    from repro_torch.kernels.flash_attention import attention_ref, mha
    from repro_torch.kernels.moe_dispatch import (moe_dispatch_sorted,
                                                  moe_dispatch_sorted_ref)
    from repro_torch.kernels.paged_kv_decode import (paged_decode,
                                                     paged_decode_ref)
    from repro_torch.kernels.ssm_scan import ssm_chunked_ref, ssm_chunked_scan

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
    flash, scans = flash_scan_geometries(launched)
    flash = flash if "flash" in only else []
    scans = scans if "scan" in only else []
    # flash and the scan draw from seeds of their own, so that a run that
    # times only some of the four sees the same data
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
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
    from repro_torch.suite.runner import SuiteRunner

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
        x = randn(t, d, dtype=dtype)
        dt = (0.95 + 0.049 * rand(t, d)).to(dtype)
        g = randn(t, d, dtype=dtype)
        want = ssm_ema_ref(x.float(), dt.float(), g.float())
        errs["ssm_ema_scan"] = max(errs["ssm_ema_scan"], check_close(
            "ssm_ema_scan", f"full T={t} D={d} chunk={chunk}",
            ssm_ema_scan(x, dt, g, chunk=chunk), want,
            tol=attn_tol(dtype, want, STREAM_TOL)))
        del want
        rows["ssm_ema_scan", dtype] = record(
            "ssm_ema_scan", f"T={t} D={d} chunk={chunk}", dtype,
            bench.ms(lambda: ssm_ema_scan(x, dt, g, chunk=chunk)),
            bench.ms(lambda: ssm_ema_ref(x, dt, g)), None,
            4 * t * d * x.element_size(), 6.0 * t * d, "f32")
        del x, dt, g
        row, err = chunked_full_width(bench, smi, dtype)
        rows["ssm_chunked_scan", dtype] = row
        errs["ssm_chunked_scan"] = max(errs["ssm_chunked_scan"], err)
    del bench
    torch.cuda.empty_cache()

    # -- 4. main path 1: the captured roster on the card -----------------------
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with record_launches() as launched:
        runner = SuiteRunner(device="cuda")
        roster = runner.roster()
        torch.cuda.synchronize()
    roster_launches = K.launch_counts()
    roster_flash = dict(flash_kernel.launches_by_kernel)
    roster_s = time.perf_counter() - t0
    bad = runner.divergent()
    say({"phase": "roster", "entries": len(roster.rows),
         "matching": len(roster.rows) - len(bad), "seconds": roster_s,
         "launches": roster_launches, "flash_launches_by_kernel": roster_flash})
    for rec in roster.records():
        say({"phase": "roster-row", **rec})
    if len(roster.rows) != 24 or bad:
        raise AssertionError(f"roster: {len(bad)} divergent entries: {bad}")
    missing = [k for k, v in roster_launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the roster: {missing}")
    if len(launched) != sum(roster_launches.values()):
        raise AssertionError(f"{len(launched)} launch specs recorded for "
                             f"{sum(roster_launches.values())} kernel launches")
    cpu_rows = SuiteRunner(device="cpu").roster().rows
    if cpu_rows != roster.rows:
        raise AssertionError("roster rows on the card differ from the rows "
                             "of the plain versions on the CPU")
    say({"phase": "roster-vs-cpu", "identical": True})

    # -- 5. main path 2: the serving roster on the card ------------------------
    K.reset_launch_counts()
    t0 = time.perf_counter()
    timelines = {}
    with record_launches() as served:
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

    # -- 6. parity at every distinct launch of both paths -----------------------
    t0 = time.perf_counter()
    held = hold_main_path(launched + served, randn, rand, errs)
    say({"phase": "main-path-parity",
         "launches": len(launched) + len(served), "distinct": held,
         "seconds": time.perf_counter() - t0})

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

    # -- 10. results --------------------------------------------------------
    kernels = []
    for kname, (source, replaces) in KERNEL_SITES.items():
        r, r16 = rows[kname, torch.float32], rows[kname, torch.bfloat16]
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": roster_launches[kname] + serving_launches[kname],
            "max_abs_err": errs[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "bf16_ms": r16["ms"], "bf16_bound_ms": r16["bound_ms"],
            "bf16_library_ms": r16["library_ms"],
        }
        if kname == "flash_attention":
            entry["launches_by_kernel"] = {
                k: roster_flash[k] + serving_flash[k] for k in roster_flash}
        kernels.append(entry)
    say({"kernels": kernels})
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
