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
16. main paths 8 and 9: the benchmark driver (``repro_torch.benchmarks
   .run``) in-process at ``DEFAULT_REFS`` on the card, once with the
   default backend (the figure, case, table3, suite and serving sections)
   and once with ``backend="cuda"`` (those and megaref and the two kernel
   tables), each with the capture memos dropped, a fresh result store,
   counters reset before and read after, its span split (a
   ``bench.section`` span per section) and each section's seconds and
   rows: every shared section equal between the two runs, table3 equal to
   phase 4's rows (45/45), no window count under the default backend and
   some under cuda, every capture kernel launched by both; megaref's host
   row equal to phase 15's NumPy-scan counters and its ndp row to a
   NumPy-scan run of it; the kernel tables (the port's STREAM and bf16
   flash kernels beside their library calls and the card's roof): each
   kernel held against its plain version on the tables' own inputs with
   phase 2's tolerances, each row's error equal to that check's, the rows
   printed with the card; then ``python -m repro_torch.study`` as four processes
   at once: the suite substrate at 20 000 refs on the card against
   ``--device cpu``, and the trace substrate's classify, metrics,
   scalability and energy tables under ``--backend cuda`` against the
   vectorized backend, each pair byte-identical;
17. the LM stack and its serving engine (``repro_torch.models``,
   ``repro_torch.serve``), after the earlier phases let go of the card's
   memory, with true float32 products (TF32 off) and the launch counters
   reset before it and read after (all 0: the LM's products are plain
   einsums, as the reference's are): (a) the seven smoke configs of the
   dense, MoE/MLA and VLM families in float32 on the card against the
   same parameters on the CPU (forward logits and aux, loss, a padded
   prefill, four decode steps, the caches; atol/rtol 1e-4, MoE top-k
   indices equal); (b) qwen2.5-14b at full width and depth, one float32
   parameter set (14.77 B, 55 GiB) drawn on the card: prefill plus 16
   decode steps against one forward for two seeded prompts (|Δlogits| <=
   1e-3 of the logits' rms), then the bf16 ``Engine`` (4 slots, max_len
   1024, buckets 128 and 512) serving 8 seeded requests of 16 tokens over
   the same parameters, with each prefill's seconds, the decode steps'
   milliseconds beside the bytes a step must move over the card's rate,
   and tokens per second; every served request's logits (its prefill's
   and its slot's row of each decode step) against one bf16 forward of
   its prompt and tokens at batch 1 (rms of the difference <= 0.05 of
   the logits' rms); then five decode steps of 4 busy slots under
   ``torch.profiler`` (device busy ms a step, kernels a step, the idle
   share against the same steps untraced, the costliest kernels); each of
   (b)-(d) does all of this; (c) deepseek-v2-lite-16b at full width, 4 of its
   27 layers (``reduced``), the invariant at capacity 64, 4 requests at
   the default capacity; (d) paligemma-3b at full width and depth, the
   invariant with 256 patch embeddings, 8 requests (no patches, as the
   reference's engine passes none);
18. the SSM, hybrid and audio families and training (``lm_1b_phase``),
   the launch counters reset before it and read after (all 0: the SSD is
   the reference's einsums, not the port's scan kernel): (a) the
   mamba2, zamba2 and whisper smoke configs in float32 on the card
   against the CPU as in 17a; (b) mamba2-780m (48 layers, d_model 1536,
   state 128; 0.78 B parameters), zamba2-7b (81 blocks: 13 groups of 5
   SSM blocks and the one shared attention+MLP block, 3 trailing; 5.74 B,
   21.4 GiB f32) and whisper-large-v3 (32 + 32 layers, 1500 seeded frame
   embeddings; 1.60 B) at full width and depth as in 17b, with the
   float32 checks (prefill plus 16 decode steps, and the float32 engine:
   4 requests of right-padded prompts in 4 slots) held against the same
   parameters computing in float64 (the rms of Δlogits over the
   vocabulary at each position <= 1e-3 of that position's rms; the
   float32 forward's own distance beside: the SSD's segment sums lose
   bits late in a 256-step chunk); the bf16 engine's served logits
   within 0.05 of the rms of a batch-1 bf16 forward (17b's bound) for
   whisper, and for mamba2 and zamba2, whose random init amplifies bf16
   rounding with depth as the reference's does
   (``tests/test_torch_models_bf16_depth.py``), reported at full depth
   and held within 0.25 on the same width cut to 2 layers and 7 blocks
   (readings 0.05-0.09 there, 0.57-0.63 at full depth); every held
   engine's control (a request's served logits against the next
   request's forward) must lie above its bound; (c) mamba2-780m trained
   through ``repro_torch.launch.train.train_loop``: bf16 compute, float32
   master weights, AdamW (bf16 moments, lr 3e-4 after 2 warm-up steps),
   batch 8 x 1024 tokens, 20 steps, each loss finite and the last five's
   mean below the first, each step timed between synchronizes (ms a
   step, tokens/s, peak memory, the model-FLOP bound 8 N tokens over the
   bf16 peak) and the sixth under ``torch.profiler`` (device busy ms,
   idle share, kernels, the costliest kernels); an asynchronous
   checkpoint at step 10 written while steps 11-20 run, loaded into a
   separate LM equal bit for bit to the snapshot the writer was handed,
   and steps 11-12 resumed within rtol 1e-5 of the uninterrupted run's
   losses; the first step at two microbatches (loss rtol 1e-5, grad norm
   1e-4, the first Adam moment within 1e-2 of the rms of one
   microbatch's, below the first microbatch alone) and with int8 error
   feedback (its dequantized gradient plus its error buffer within 1e-2
   of the uncompressed step's gradient, every error within half a code,
   ``compress_rel_err`` < 0.2);
19. the whole-model capture and zoo (``models_phase``), then the CI
   gates (``gates_phase``): (a) one qwen2.5-14b smoke decode step
   (batch 2, 256-token cache) captured with its LM on the card and again
   on ``meta``: equal ops, FLOPs, footprint and walk; (b) main paths 10
   and 11: the models roster of the driver's CI pair (qwen2.5-14b and
   mamba2-780m, 51 entries, ``models_registry(only=..., device="cuda")``)
   under the vectorized and the ``cuda`` backend, counters reset before
   and read after, each traced with its span split (capture, walk,
   simulation): 51/51 classes equal to the port's pins, rows equal, no
   window count under the vectorized backend and some under cuda;
   (c) main path 12: the driver's ``models_sweep`` (the bs64 decode
   step streamed op by op into ``simulate_chunked``) under both
   backends: equal rows, and ``perf_gate``'s counter gate
   (``capture.model.concat == 0``, ``capture.model.stream_blocks > 0``)
   over each run's trace; (d) qwen2.5-14b at full width and depth (48
   layers, d_model 5120), one decode step at batch 1 against a 256-token
   cache captured on ``meta``: its op census, footprint, whole-step refs
   and counted FLOPs, its dense FLOPs within 1% of 2 x (non-embedding
   parameters + head) + 4 H D cache L, and a centred 200 000-ref window
   classified under both backends with equal rows; then
   ``timing_smoke`` (a cold 250k-ref cell per family within 2 s under
   both backends) and ``perf_gate``: ``python -m
   repro_torch.benchmarks.run --fast`` in a fresh process on the card
   against the committed ``src/repro_torch/benchmarks/baseline_h100.json``
   (every section within 2x, the kernel-timing sections skipped);
20. the cost substrate and the launch layer (``launch_phase``; no kernel
   launches): (a) the ``hlo`` substrate's 64 rows against ``H100_SXM``,
   counted by class and timed; (b) ``python -m repro_torch.launch.dryrun``
   in three child processes at once, at full width on the production
   meshes over a fake process group: qwen2.5-14b ``decode_32k`` on
   2x16x16, deepseek-moe-16b ``train_4k`` and mamba2-780m ``prefill_32k``
   on 16x16; each entry ``ok``, its argument bytes equal to the sum of
   its leaves' local shard bytes as the phase computes them from the
   abstract mesh, its per-card argument and temp GB printed against
   80 GB with its collective bytes by op and its seconds; (c) mamba2-780m
   ``decode_32k`` placed by ``build_cell`` on ``make_local_mesh()`` (one
   rank, NCCL) on the card at full width: 48 layers, batch 128, bf16
   weights and an f32 state of 9.7 GB drawn from seed 0; one decode step
   against the same step of a plain ``LM`` on the same parameters (bit
   for bit expected; at most 1e-5 of the logits' rms), then the median
   of 5 steps against ``analytic.cell_cost``'s ``t_bound`` on
   ``H100_SXM``, with their ratio;
21. prints the kernels line (``launches`` summed over main paths 1 and 2,
   as before, for the seven capture kernels and main path 6's first
   cuda run for the window count; ``launches_by_path`` for paths 1-4,
   6-9, ``models`` (path 11) and ``models_sweep`` (path 12's cuda run);
   flash's also split by kernel; the f32 (window count: int32) timings,
   and the bf16 ones as ``bf16_ms``, ``bf16_bound_ms``,
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
import gc
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:   # imported from src/ at run time, after the path is set
    from repro_torch.benchmarks.kernel_bench import CardBench as Bench

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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

    from repro_torch.benchmarks.kernel_bench import stream_calls

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
            kern, plain, _, _ = streams[op]
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
                  "suite.", "serving.", "bench.")
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


def window_scan_main_path(calls: list, smi: str, bench: Bench,
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


def megaref_phase(K, smi: str):
    """``simulate_chunked`` over the megaref trace at ``MEGAREF_REFS``,
    with the NumPy scan and with ``scan="cuda"``: equal counters; and on a
    ``MEGAREF_PREFIX`` prefix both equal the in-memory ``simulate``.
    Returns the NumPy scan's result."""
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
    return runs["numpy"]


# -- the benchmark driver and the study CLI -------------------------------

# The driver's sections that both backends run (figures, cases, tables,
# the roster and serving sections); the cuda run adds megaref and the
# kernel tables.
FIGURE_SECTIONS = ("fig1", "fig3", "fig4", "fig5", "fig5_nuca", "fig7",
                   "fig18", "table3", "suite", "serving", "serving_warm",
                   "case1", "case2", "case3", "case4")
CUDA_ONLY_SECTIONS = ("megaref", "kernels_stream", "kernels_attention")
SHOWN_ROWS = 20             # a section's rows are printed up to this many


def driver_run(K, trace_dir: Path, smi: str, backend: str | None,
               sections: tuple) -> tuple[dict, dict, object]:
    """One in-process run of ``python -m repro_torch.benchmarks.run
    --device cuda [--backend cuda] --only <sections>`` at ``DEFAULT_REFS``
    (capture memos dropped, a fresh result store, its CSV into
    ``trace_dir``), traced, counters set to 0 before and read after; its
    perf record's meta names the card.  Prints each section's seconds and
    rows and the run's span split.  Returns the sections, the launches
    and the span split."""
    from repro_torch.benchmarks import run as bench_run

    label = f"figures-{backend or 'default'}"
    record = trace_dir / f"{label}.json"
    argv = ["--device", "cuda", "--only", ",".join(sections),
            "--bench-json", str(record)]
    if backend:
        argv += ["--backend", backend]
    args = bench_run.build_parser().parse_args(argv)
    os.environ["REPRO_TORCH_SUITE_STORE"] = str(trace_dir / f"{label}-store")

    def drive():
        forget_captures()
        with open(trace_dir / f"{label}.csv", "w") as out, \
                contextlib.redirect_stdout(out):
            return bench_run.run(args)

    with obs_trace(trace_dir, label):
        res, launches, secs = counted(K, drive)
    bench_run.write_record(args, res)
    (bucket,) = json.loads(record.read_text())["runs"].values()
    for name, sec in res["sections"].items():
        row = {"phase": "figures-section", "backend": backend or "default",
               "section": name, "seconds": sec["seconds"],
               "rows": len(sec["rows"]), "card": smi}
        if len(sec["rows"]) <= SHOWN_ROWS:
            row["header"] = sec["header"]
            row["table"] = [list(r) for r in sec["rows"]]
        say(row)
    say({"phase": "figures", "backend": backend or "default",
         "seconds": secs, "sections": len(res["sections"]),
         "engine": res["study"].stats.as_dict(), "launches": launches,
         "meta": bucket["meta"], "card": smi})
    rep = span_split(trace_dir, label, smi)
    if set(res["sections"]) != set(sections):
        raise AssertionError(f"{label}: ran {list(res['sections'])}")
    empty = [n for n, sec in res["sections"].items() if not sec["rows"]]
    if empty:
        raise AssertionError(f"{label}: sections without rows: {empty}")
    if bucket["meta"].get("card") is None:
        raise AssertionError(f"{label}: the perf record names no card")
    return res["sections"], launches, rep


def cli_tables(commands: dict[str, list[str]], trace_dir: Path
               ) -> dict[str, str]:
    """Run ``python -m repro_torch.study`` once per command, all at once,
    each with a result store of its own; returns each one's stdout.  Every
    process is waited for, and killed if this raises first."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    try:
        for name, argv in commands.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.study", *argv],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=dict(env, REPRO_TORCH_SUITE_STORE=str(
                    trace_dir / f"cli-{name}-store")))
        outs = {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"study CLI {name} exited "
                                     f"{proc.returncode}: {err[-2000:]}")
            outs[name] = out
        return outs
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def hold_kernel_bench(sections: dict, errs: dict[str, float]) -> None:
    """The kernel tables' kernels against their plain versions on the
    tables' own seeded inputs, with phase 2's tolerances: STREAM exact,
    bf16 flash within ``attn_tol`` of the float32 plain output (rtol 1e-2,
    atol 1e-3 of its rms); each table row's ``max_abs_err`` must equal the
    check's (both kernels are deterministic).  Prints the rows."""
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.kernels.flash_attention import attention_ref, mha

    found = {}
    a, b = kb.stream_inputs("cuda")
    for op, (entry, plain, _, _) in kb.stream_calls().items():
        found[f"stream_{op}"] = check_close(
            "stream", f"kernel-bench {op} n={kb.STREAM_N}",
            entry(a, b, kb.STREAM_Q), plain(a, b, kb.STREAM_Q), exact=True)
        errs["stream"] = max(errs["stream"], found[f"stream_{op}"])
    del a, b
    for (bsz, s, h, g, d), q, k, v in kb.attention_inputs("cuda"):
        want = attention_ref(q.float(), k.float(), v.float(), causal=True)
        err = check_close(
            "flash_attention", f"kernel-bench bf16 causal b={bsz} s={s} "
            f"h={h} g={g} d={d}", mha(q, k, v, causal=True), want,
            tol=attn_tol(torch.bfloat16, want))
        found[f"attn_b{bsz}s{s}h{h}g{g}"] = err
        errs["flash_attention"] = max(errs["flash_attention"], err)
    for sec in sections.values():
        for r in sec["rows"]:
            row = dict(zip(sec["header"], r))
            say({"phase": "kernel-bench", **row})
            if row["max_abs_err"] != found.pop(row["kernel"]):
                raise AssertionError(f"kernel-bench {row['kernel']}: the "
                                     f"table's error {row['max_abs_err']} "
                                     f"is not the check's")
    if found:
        raise AssertionError(f"kernel-bench: no table row for {list(found)}")


def figures_phase(K, trace_dir: Path, smi: str, roster_rows: list,
                  megaref_host, errs: dict[str, float]) -> tuple[dict, dict]:
    """Main paths 8-9: the benchmark driver's sections at ``DEFAULT_REFS``
    on the card, once with the default backend and once with
    ``backend="cuda"`` (which adds megaref and the kernel tables): every
    figure, case, table, roster and serving section equal between the two,
    table3 equal to phase 4's roster rows, the default run launching no
    window count and the cuda run some, megaref's host row equal to phase
    15's NumPy-scan counters and its ndp row to a NumPy-scan run of that
    row alone; the kernel tables' kernels held against their plain
    versions (:func:`hold_kernel_bench`) and the rows printed with the
    card.  Then the study
    CLI as subprocesses: the suite substrate on the card against
    ``--device cpu``, and the trace substrate's classify, metrics,
    scalability and energy tables under ``--backend cuda`` against the
    vectorized backend.  Returns both runs' launches."""
    from repro_torch.core import cachesim
    from repro_torch.core.cachesim_stream import (DEFAULT_CHUNK,
                                                  simulate_chunked)

    default, default_launches, _ = driver_run(K, trace_dir, smi, None,
                                              FIGURE_SECTIONS)
    cuda, cuda_launches, rep = driver_run(
        K, trace_dir, smi, "cuda", FIGURE_SECTIONS + CUDA_ONLY_SECTIONS)
    differ = [n for n in FIGURE_SECTIONS
              if (default[n]["header"], default[n]["rows"])
              != (cuda[n]["header"], cuda[n]["rows"])]
    if differ:
        raise AssertionError(f"figures: sections differ between the default "
                             f"and the cuda backend: {differ}")
    if default["table3"]["rows"] != roster_rows:
        raise AssertionError("figures: table3 differs from phase 4's roster")
    matched = sum(r[5] for r in default["table3"]["rows"])
    if default_launches[SCAN_KERNEL] != 0 or cuda_launches[SCAN_KERNEL] <= 0 \
            or rep.counter("scan.cuda") <= 0:
        raise AssertionError("figures: window counts launched "
                             f"{default_launches[SCAN_KERNEL]} (default), "
                             f"{cuda_launches[SCAN_KERNEL]} (cuda)")
    missing = [k for k in KERNEL_SITES if k != SCAN_KERNEL
               and (default_launches[k] <= 0 or cuda_launches[k] <= 0)]
    if matched != 45 or missing:
        raise AssertionError(f"figures: table3 {matched}/45, kernels not "
                             f"launched: {missing}")
    say({"phase": "figures-vs-backends", "identical": list(FIGURE_SECTIONS),
         "table3_equals_roster": True, "table3_matching": matched,
         "seconds": {"default": sum(default[n]["seconds"]
                                    for n in FIGURE_SECTIONS),
                     "cuda": sum(cuda[n]["seconds"]
                                 for n in FIGURE_SECTIONS)},
         "card": smi})

    # megaref under cuda: host row against phase 15's NumPy-scan counters
    # (the same trace), ndp row against a NumPy-scan run of it alone
    host, ndp = cuda["megaref"]["rows"]
    addr = megaref_trace(MEGAREF_REFS)
    t0 = time.perf_counter()
    ndp_sim = simulate_chunked(addr, cachesim.ndp_config(4),
                               chunk=DEFAULT_CHUNK, name="megaref.ndp")
    numpy_s = time.perf_counter() - t0
    want = [(megaref_host.l1_misses, megaref_host.level_misses[-1],
             round(megaref_host.lfmr, 4), round(megaref_host.mpki, 2)),
            (ndp_sim.l1_misses, ndp_sim.level_misses[-1],
             round(ndp_sim.lfmr, 4), round(ndp_sim.mpki, 2))]
    got = [tuple(host[3:]), tuple(ndp[3:])]
    say({"phase": "figures-megaref", "rows": [list(host), list(ndp)],
         "numpy": [list(w) for w in want], "ndp_numpy_seconds": numpy_s,
         "card": smi})
    if got != want or host[1] != MEGAREF_REFS:
        raise AssertionError(f"figures: megaref rows {got} differ from the "
                             f"NumPy scan's {want}")
    hold_kernel_bench({name: cuda[name] for name in
                       ("kernels_stream", "kernels_attention")}, errs)
    del addr

    # the study CLI: the card against the CPU and the vectorized backend
    t0 = time.perf_counter()
    trace = ["--substrate", "trace", "--sections",
             "classify,metrics,scalability,energy"]
    outs = cli_tables({
        "suite-cuda": ["--substrate", "suite", "--refs", "20000"],
        "suite-cpu": ["--substrate", "suite", "--refs", "20000",
                      "--device", "cpu"],
        "trace-cuda": trace + ["--backend", "cuda"],
        "trace-vectorized": trace}, trace_dir)
    same = {"suite": outs["suite-cuda"] == outs["suite-cpu"],
            "trace": outs["trace-cuda"] == outs["trace-vectorized"]}
    say({"phase": "study-cli", "identical": same,
         "lines": {k: len(v.splitlines()) for k, v in outs.items()},
         "seconds": time.perf_counter() - t0, "card": smi})
    if not all(same.values()) \
            or len(outs["suite-cuda"].strip().splitlines()) != 2 + 45 \
            or not outs["trace-cuda"].startswith("## classification"):
        raise AssertionError(f"study CLI: tables differ {same}")
    return default_launches, cuda_launches



# -- the LM stack and its serving engine ------------------------------------

# The smoke configs of the dense, MoE/MLA and VLM families.
LM_SMOKE = ("qwen2.5-14b", "phi4-mini-3.8b", "nemotron-4-340b", "granite-20b",
            "deepseek-moe-16b", "deepseek-v2-lite-16b", "paligemma-3b")
LM_TOL = dict(atol=1e-4, rtol=1e-4)    # tests/test_models.py's
LM_INVARIANT = 1e-3    # prefill + decode against forward, of the logits' rms
# The bf16 engine's logits against one bf16 forward of the same sequence
# at batch 1: the rms of the difference over the logits' rms, at every
# served position (tests/test_torch_models_vlm.py's bf16 bound; the two
# sides round at the same points but multiply in other shapes, so cuBLAS
# sums in other orders)
LM_BF16_RMS = 0.05
# The SSM and hybrid families' bf16 engine (their random init amplifies
# bf16 rounding with depth: 0.42-0.73 of the rms at full depth), held on
# the same width cut to 2 layers (mamba2) and 7 blocks (zamba2) by the
# same metric: it reads 0.053 and 0.086 there, the control (another
# request's forward) 1.42-1.43 (PERF.md, section 6).
LM_SSM_BF16_RMS = 0.25
LM_SEED = 21


@contextlib.contextmanager
def recorded_routes():
    """Every MoE router call's top-k indices, in call order."""
    from repro_torch.models import moe

    route, seen = moe.route, []

    def recording(*args, **kw):
        out = route(*args, **kw)
        seen.append(out[2].cpu())
        return out
    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = route


def lm_run(lm, tokens, labels, extra, padded, prompt_len, steps):
    """forward (logits, aux), loss, a padded prefill and ``steps`` decode
    steps of ``lm`` on its device; the tensors come back to the host."""
    dev = lm.device

    def on(x):
        return None if x is None else x.to(dev)
    batch = {"tokens": on(tokens), "labels": on(labels)}
    if extra is not None:
        batch["extra_embed"] = on(extra)
    with torch.inference_mode():
        logits, aux = lm(on(tokens), extra_embed=on(extra))
        loss = lm.loss(batch)
        lg, cache, pos = lm.prefill(on(padded), lm.init_cache(2, 48),
                                    extra_embed=on(extra),
                                    prompt_len=on(prompt_len))
        out = {"logits": logits, "aux": aux, "loss": loss, "prefill": lg,
               "next_pos": pos}
        for i, tok in enumerate(steps):
            lg, cache = lm.decode_step(on(tok), cache, pos)
            pos = pos + 1
            out[f"decode{i}"] = lg
        out.update({f"cache.{k}": v for k, v in cache_leaves(cache)})
    return {k: v.cpu() for k, v in out.items()}


def cache_leaves(cache: dict, prefix: str = ""):
    """(dotted name, tensor) of a nested cache dict."""
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from cache_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def lm_smoke_parity(smi: str, archs=LM_SMOKE, phase: str = "lm") -> None:
    """17a and 18a: each smoke config in float32 on the card against the
    same parameters (one CPU init, copied across) on the CPU."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import LM

    for arch in archs:
        cfg = configs.get_smoke(arch).replace(dtype="float32")
        t0 = time.perf_counter()
        cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        card = LM(cfg, device="cuda")
        card.load_state_dict(cpu.state_dict())
        g = torch.Generator().manual_seed(LM_SEED)
        tokens = torch.randint(1, cfg.vocab, (2, 24), generator=g)
        labels = torch.randint(0, cfg.vocab, (2, 24), generator=g)
        labels[0, :5] = -1
        n_extra = {"vlm": cfg.n_img_tokens,
                   "audio": cfg.enc_ctx}.get(cfg.family)
        extra = (0.1 * torch.randn(2, n_extra, cfg.d_model, generator=g)
                 if n_extra else None)
        padded = torch.randint(1, cfg.vocab, (2, 16), generator=g)
        prompt_len = torch.tensor([7, 16], dtype=torch.int32)
        steps = [torch.randint(1, cfg.vocab, (2, 1), generator=g)
                 for _ in range(4)]
        with recorded_routes() as cpu_routes:
            want = lm_run(cpu, tokens, labels, extra, padded, prompt_len,
                          steps)
        with recorded_routes() as card_routes:
            got = lm_run(card, tokens, labels, extra, padded, prompt_len,
                         steps)
        errs = {}
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), **LM_TOL,
                                       err_msg=f"{arch} {k}")
            errs[k] = float((got[k].double() - w.double()).abs().max())
        if len(card_routes) != len(cpu_routes) or not all(
                torch.equal(a, b) for a, b in zip(card_routes, cpu_routes)):
            raise AssertionError(f"{arch}: MoE top-k indices on the card "
                                 f"differ from the CPU's")
        say({"phase": phase, "part": "a-smoke-parity", "arch": arch,
             "tol": LM_TOL, "max_abs_err": errs,
             "moe_routes_equal": len(card_routes),
             "seconds": time.perf_counter() - t0, "card": smi})
        del cpu, card


def position_rms(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """At each position (leading axes), the rms over the vocabulary of
    ``got - want`` over that of ``want``."""
    got, want = got.double(), want.double()
    return (got - want).pow(2).mean(-1).sqrt() / want.pow(2).mean(-1).sqrt()


def f32_invariant(lm, rng, n_extra: int = 0, yardstick=None) -> dict:
    """Two prompts of seeded lengths 100-400, each a batch of one: prefill
    plus 16 decode steps against one forward over the whole sequence, in
    float32 on the card; ``n_extra`` seeded patch (VLM) or frame (audio)
    embeddings; held to ``LM_INVARIANT`` of the logits' rms on the largest
    entry.  ``yardstick`` (the same parameters computing in float64, the
    SSD too) gives the forward the steps are held against, where the
    float32 forward is the less exact side (the SSD late in a chunk); the
    float32 forward's distance from it is reported beside, and the steps
    are held by the engine check's metric instead (``position_rms``, the
    worst position): the largest entry over the whole tensor's rms left
    no room there (it read 0.965e-3 for mamba2-780m)."""
    cfg = lm.cfg
    errs = []
    for _ in range(2):
        n = int(rng.integers(100, 401))
        tokens = torch.from_numpy(
            rng.integers(1, cfg.vocab, size=(1, n + 16))).to(lm.device)
        extra = None
        if n_extra:
            g = torch.Generator(device=lm.device).manual_seed(n)
            extra = 0.1 * torch.randn(1, n_extra, cfg.d_model, generator=g,
                                      device=lm.device)
        with torch.inference_mode():
            full, _ = lm(tokens, extra_embed=extra)
            held = full if yardstick is None else yardstick(
                tokens, extra_embed=extra)[0]
            rms = float(held.double().pow(2).mean().sqrt())
            full, held = full[:, n - 1:], held[:, n - 1:]
            prefix = n_extra if cfg.family == "vlm" else 0
            lg, cache, pos = lm.prefill(
                tokens[:, :n], lm.init_cache(1, prefix + n + 16),
                extra_embed=extra)
            steps = [lg[:, 0]]
            for t in range(n, n + 16):
                lg, cache = lm.decode_step(tokens[:, t:t + 1], cache, pos)
                pos = pos + 1
                steps.append(lg[:, 0])
            steps = torch.stack(steps, dim=1).double()
            err = float((steps - held.double()).abs().max())
            row = {"prompt": n, "max_abs_err": err, "logits_rms": rms,
                   "err_over_rms": err / rms,
                   "position_rms_max": float(position_rms(steps, held).max())}
            if yardstick is not None:
                row["held_against"] = "float64 forward"
                row["steps_vs_f32_forward_over_rms"] = float(
                    (steps - full.double()).abs().max()) / rms
                row["f32_forward_vs_f64_over_rms"] = float(
                    (full.double() - held.double()).abs().max()) / rms
                row["f32_forward_vs_f64_position_rms_max"] = float(
                    position_rms(full, held).max())
        errs.append(row)
        del full, held, cache, steps
        worst = row["position_rms_max"] if yardstick is not None \
            else row["err_over_rms"]
        if worst > LM_INVARIANT:
            raise AssertionError(f"{cfg.name}: prefill + decode differ from "
                                 f"forward by {worst} > {LM_INVARIANT} of "
                                 f"the rms")
    return {"prompts": errs, "bound": LM_INVARIANT,
            "held": "position_rms_max" if yardstick is not None
            else "err_over_rms"}


def decode_bytes(lm) -> tuple[int, int, int]:
    """What one decode step must move, as (the float32 weights it reads
    once, bytes per cached attention position of a slot, bytes per slot
    whatever its position).  The audio family's encoder and its cross
    K/V projections are not read (the cross K/V come from the cache, read
    whole); an SSM block reads and writes its f32 state and conv rows."""
    from repro_torch.models.model import hybrid_layout

    cfg = lm.cfg
    item = lm.dtype.itemsize
    weights = sum(p.numel() * p.element_size()
                  for n, p in lm.named_parameters()
                  if not (n.startswith("enc_") or ".xattn.wk" in n
                          or ".xattn.wv" in n))
    kv_row = (cfg.kv_lora_rank + cfg.rope_head_dim if cfg.kv_lora_rank
              else 2 * cfg.n_kv_heads * cfg.resolved_head_dim)
    g, per, trailing = (hybrid_layout(cfg) if cfg.family == "hybrid"
                        else (0, 0, 0))
    n_attn = {"ssm": 0, "hybrid": g}.get(cfg.family, cfg.n_layers)
    n_ssm = {"ssm": cfg.n_layers,
             "hybrid": g * per + trailing}.get(cfg.family, 0)
    slot = n_ssm * 2 * (cfg.n_ssm_heads * cfg.ssm_state * cfg.ssm_head_dim
                        * 4 + (cfg.ssm_conv - 1)
                        * (cfg.d_inner + 2 * cfg.ssm_state) * item)
    if cfg.family == "audio":
        slot += cfg.n_layers * cfg.enc_ctx * kv_row * item
    return weights, n_attn * kv_row * item, slot


class TimedLM:
    """The LM as the engine calls it, each prefill and decode step timed
    between two synchronizes; the decode step's bound counts the bytes
    it must move (``decode_bytes``): the float32 weights read once, each
    slot's cache rows up to its position and its fixed state (SSM state,
    cross-attention K/V)."""

    def __init__(self, lm, hbm_bytes_per_s: float):
        self.lm = lm
        self.rate = hbm_bytes_per_s
        self.weight_bytes, self.row_bytes, self.slot_bytes = decode_bytes(lm)
        self.prefill_s, self.prompt_tokens, self.decode_s, self.bound_s = \
            [], [], [], []
        # the last logits of each prefill, in admission order, and of the
        # latest decode step (every slot's row)
        self.prefill_logits, self.decode_logits = [], None

    def init_cache(self, batch: int, max_len: int):
        self.max_len = max_len
        return self.lm.init_cache(batch, max_len)

    def cache_axes(self):
        return self.lm.cache_axes()

    def _timed(self, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def prefill(self, tokens, cache, *, prompt_len):
        out, secs = self._timed(self.lm.prefill, tokens, cache,
                                prompt_len=prompt_len)
        self.prefill_s.append(secs)
        self.prompt_tokens.append(int(prompt_len[0]))
        self.prefill_logits.append(out[0][0, -1])
        return out

    def decode_step(self, tokens, cache, pos):
        rows = int((pos.clamp(max=self.max_len - 1) + 1).sum())
        out, secs = self._timed(self.lm.decode_step, tokens, cache, pos)
        self.decode_s.append(secs)
        self.bound_s.append((self.weight_bytes + rows * self.row_bytes
                             + len(pos) * self.slot_bytes) / self.rate)
        self.decode_logits = out[0][:, 0]
        return out


def hold_served(lm, reqs, logits: dict, frames=None, bound=LM_BF16_RMS,
                f32_lm=None, ref_lm=None) -> dict:
    """Each served request's logits (its prefill's last, then its row of
    every decode step) against one forward of its prompt and tokens at
    batch 1 on the card in the LM's dtype: ``position_rms`` at each
    position within ``bound``.  In an MoE a router whose 6th and 7th
    choices lie within a bf16 step may choose another expert when the
    products' shapes change, which moves that one position (a third of
    the rms at smoke size): there the bound holds each request's median
    position, elsewhere every position.  ``ref_lm`` computes that forward
    instead (the float64 yardstick of ``f32_invariant``).  The control
    sets each request's served logits against the next request's
    forward, what a slot that read another's cache would serve; the
    bound must lie below it.

    ``bound=None`` reports without holding, for a model whose bf16
    logits no fixed bound can hold (the SSM families at full depth, whose
    random init amplifies bf16 rounding with depth as the reference's
    does: tests/test_torch_models_bf16_depth.py); ``f32_lm`` (the same
    parameters computing in float32) then reports the bf16 forward's own
    distance from float32 beside the served logits'."""
    import numpy as np

    stat = torch.median if lm.cfg.is_moe else torch.max
    wants, gots = [], []
    worst, median, gap = 0.0, 0.0, 0.0
    noise, served32 = [], []
    for r in reqs:
        n = len(r.prompt)
        seq = torch.from_numpy(
            np.concatenate([r.prompt, r.out_tokens[:-1]])[None]).to(lm.device)
        with torch.inference_mode():
            want = (ref_lm or lm)(seq, extra_embed=frames)[0][
                0, n - 1:].float()
        got = torch.stack(logits[r.rid]).float()
        if got.shape != want.shape:
            raise AssertionError(f"{lm.cfg.name} request {r.rid}: "
                                 f"{tuple(got.shape)} logits served for "
                                 f"{tuple(want.shape)}")
        rms = want.pow(2).mean(-1).sqrt()
        rel = position_rms(got, want)
        tok = torch.tensor(r.out_tokens, device=lm.device)
        if not torch.equal(got.argmax(-1), tok):
            raise AssertionError(f"{lm.cfg.name} request {r.rid}: tokens "
                                 f"are not the argmax of its logits")
        # how far below the forward's top logit each served token lies
        below = (want.max(-1).values - want.gather(1, tok[:, None])[:, 0])
        worst = max(worst, float(rel.max()))
        median = max(median, float(rel.median()))
        gap = max(gap, float((below / rms).max()))
        if f32_lm is not None:
            with torch.inference_mode():
                w32 = f32_lm(seq, extra_embed=frames)[0][0, n - 1:]
            noise.append(float(position_rms(want, w32).max()))
            served32.append(float(position_rms(got, w32).max()))
            del w32
        wants.append(want)
        gots.append(got)
    control = min(float(stat(position_rms(g, w)))
                  for g, w in zip(gots, wants[1:] + wants[:1]))
    del wants, gots
    held = median if lm.cfg.is_moe else worst
    out = {"served_vs_forward_rms_max": worst,
           "served_vs_forward_rms_median": median,
           "served_token_below_top_over_rms": gap,
           "control_other_request": control,
           "held": "median" if lm.cfg.is_moe else "max", "bound": bound}
    if f32_lm is not None:
        out.update(bf16_forward_vs_f32_rms_max=noise,
                   served_vs_f32_rms_max=served32)
    if bound is not None and not held <= bound < control:
        raise AssertionError(f"{lm.cfg.name}: served logits differ from a "
                             f"batch-1 forward by {held} x rms (bound "
                             f"{bound}, control {control})")
    return out


def serve_bf16(lm, n_requests: int, rate: float, smi: str, *,
               hold: bool = True, frames=None, bound=LM_BF16_RMS,
               f32_lm=None, ref_lm=None) -> dict:
    """The bf16 server: ``Engine(max_batch=4, max_len=1024,
    prompt_buckets=(128, 512))`` over ``lm`` (float32 parameters, the
    config's bf16 compute), ``n_requests`` seeded prompts of 64-500 tokens,
    16 new tokens each; ``hold``: the served logits against a batch-1
    forward (``hold_served``), which an MoE that drops tokens cannot meet:
    its capacity counts the padded bucket and the batch's slots, as the
    reference's does.  ``frames``: the audio family's encoder input, given
    to every prefill (``FramedLM``) and to the batch-1 forward."""
    import numpy as np

    from repro_torch.serve import Engine, FramedLM, Request

    timed = TimedLM(lm if frames is None else FramedLM(lm, frames), rate)
    rng = np.random.default_rng(LM_SEED + n_requests)
    reqs = [Request(rid=i, prompt=rng.integers(
                1, lm.cfg.vocab, size=int(rng.integers(64, 501))),
                max_new_tokens=16)
            for i in range(n_requests)]
    engine = Engine(timed, max_batch=4, max_len=1024,
                    prompt_buckets=(128, 512))
    logits = {r.rid: [] for r in reqs}
    t0 = time.perf_counter()
    with torch.inference_mode():
        # Engine.run's loop, admitting first so that each decode step's
        # rows can be given to the requests in its slots
        for r in reqs:
            engine.submit(r)
        while engine.queue or engine.active:
            engine._admit()
            slots = {slot: r.rid for slot, r in engine.active.items()}
            engine.step()
            for slot, rid in slots.items():
                logits[rid].append(timed.decode_logits[slot])
    secs = time.perf_counter() - t0
    out = {r.rid: r.out_tokens for r in reqs}
    for rid, first in enumerate(timed.prefill_logits):   # FIFO admission
        logits[rid].insert(0, first)
    bad = {rid: toks for rid, toks in out.items()
           if len(toks) != 16 or not all(0 <= t < lm.cfg.vocab for t in toks)}
    if bad:
        raise AssertionError(f"{lm.cfg.name}: requests not served 16 tokens "
                             f"inside the vocabulary: {bad}")
    held = hold_served(lm, reqs, logits, frames, bound, f32_lm,
                       ref_lm) if hold else {}
    dec = sorted(timed.decode_s)
    med = dec[len(dec) // 2]
    bound = sorted(timed.bound_s)[len(dec) // 2]
    del engine, logits
    return {
        **held,
        "requests": n_requests, "slots": 4, "max_len": 1024,
        "buckets": [128, 512], "new_tokens": 16 * n_requests,
        "prompt_tokens": timed.prompt_tokens,
        "prefill_s_per_request": timed.prefill_s,
        "prefill_tokens_per_s": sum(timed.prompt_tokens) / sum(timed.prefill_s),
        "decode_steps": len(dec), "decode_ms_median": 1e3 * med,
        "decode_ms_min": 1e3 * dec[0], "decode_ms_max": 1e3 * dec[-1],
        "decode_bound_ms": 1e3 * bound,
        "decode_bound_share": bound / med,
        "decode_weight_bytes": timed.weight_bytes,
        "decode_slot_bytes": timed.slot_bytes,
        "wall_s": secs, "tokens_per_s": 16 * n_requests / secs,
        "first_tokens": {rid: toks[:4] for rid, toks in out.items()},
        "card": smi}


def profile_decode(lm, smi: str, steps: int = 5, frames=None) -> dict:
    """The bf16 engine's decode step under ``torch.profiler``: 4 slots
    busy with seeded prompts of 64-500 tokens, ``steps`` steps timed on
    the host clock between synchronizes, then the same number traced.
    Device busy time is the union of the traced kernels' and copies'
    intervals; the idle share sets it against the untraced steps'."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Engine, FramedLM, Request

    rng = np.random.default_rng(LM_SEED)
    engine = Engine(lm if frames is None else FramedLM(lm, frames),
                    max_batch=4, max_len=1024, prompt_buckets=(128, 512))
    for i in range(4):
        engine.submit(Request(rid=i, prompt=rng.integers(
            1, lm.cfg.vocab, size=int(rng.integers(64, 501))),
            max_new_tokens=1 + 2 * (steps + 2)))
    with torch.inference_mode():
        for _ in range(2):                       # admit, warm
            engine.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
    if len(engine.active) != 4:
        raise AssertionError("profile: a slot retired inside the window")
    del engine
    return profile_summary(prof, steps, wall, smi)


def profile_summary(prof, steps: int, wall: float, smi: str) -> dict:
    """A ``torch.profiler`` window of ``steps`` steps against their
    untraced ``wall`` seconds a step: device busy ms a step (the union of
    the kernels' and copies' intervals), the idle share, kernels and
    copies a step and the costliest kernels."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return {"profiled_steps": steps, "wall_ms_per_step": 1e3 * wall,
                "device_events": 0, "device_busy": "not measured",
                "card": smi}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -1.0
    for a, b in spans:                           # union, microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    by_name: dict = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    busy_ms = busy / 1e3 / steps
    return {"profiled_steps": steps, "wall_ms_per_step": 1e3 * wall,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1 - busy_ms / (1e3 * wall),
            "kernels_per_step": (len(dev) - len(copies)) / steps,
            "copies_per_step": len(copies) / steps,
            "top": [{"name": n[:100], "calls_per_step": c / steps,
                     "ms_per_step": us / 1e3 / steps}
                    for n, (c, us) in top],
            "card": smi}


def lm_full_width(arch: str, smi: str, rate: float, *, n_layers=None,
                  n_extra: int = 0, n_requests: int = 8,
                  invariant_changes=None, phase: str = "lm",
                  engine_invariant: bool = False,
                  bf16_held_layers=None) -> None:
    """17b-d: ``arch`` at full width (depth cut to ``n_layers`` where
    given), one float32 parameter set drawn on the card, its float32
    invariant and its bf16 engine run over the same parameters.  Where
    ``invariant_changes`` are given (an MoE made dropless), the engine
    serves at the config's own settings and then again under the changes,
    whose served logits are held against a batch-1 forward.

    18b adds ``engine_invariant``: a float32 engine run held against the
    float64 forward, and the bf16 run's distances from the float32
    forward reported.  ``bf16_held_layers``: the bf16 engine at full depth
    is reported, not held (``hold_served``), and held instead to
    ``LM_SSM_BF16_RMS`` on the same width cut to that many layers, drawn
    from the same seed."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import LM

    cfg = configs.get(arch)
    reduced = {}
    if n_layers is not None:
        reduced["n_layers"] = [cfg.n_layers, n_layers]
        cfg = cfg.replace(n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg.replace(dtype="float32"), device="cuda")
    lm.init(torch.Generator(device=lm.device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    t0 = time.perf_counter()
    f64 = lm.with_config(lm.cfg.replace(dtype="float64")) \
        if engine_invariant else None
    inv = f32_invariant(lm.with_config(lm.cfg.replace(
        **(invariant_changes or {}))), np.random.default_rng(LM_SEED),
        n_extra=n_extra, yardstick=f64)
    say({"phase": phase, "part": "f32-invariant", "arch": arch,
         "reduced": reduced, "params": n_params,
         "param_gib": n_params * 4 / 2**30, "init_s": init_s,
         "changes": invariant_changes or {}, "patch_embeddings": n_extra,
         **inv, "seconds": time.perf_counter() - t0, "card": smi})
    frames = None
    if cfg.family == "audio":        # the encoder's input, seeded
        g = torch.Generator(device=lm.device).manual_seed(LM_SEED)
        frames = 0.1 * torch.randn(1, cfg.enc_ctx, cfg.d_model, generator=g,
                                   device=lm.device)
    if engine_invariant:
        # the f32 engine: right-padded prompts in 4 slots, each served
        # logit against a batch-1 forward (the float64 yardstick)
        t0 = time.perf_counter()
        inv = serve_bf16(lm, 4, rate, smi, frames=frames,
                         bound=LM_INVARIANT, ref_lm=f64)
        say({"phase": phase, "part": "f32-engine-invariant", "arch": arch,
             **{k: inv[k] for k in ("served_vs_forward_rms_max",
                                    "served_vs_forward_rms_median", "bound",
                                    "control_other_request",
                                    "prompt_tokens", "decode_ms_median",
                                    "card")},
             "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    served = serve_bf16(lm.with_config(cfg), n_requests, rate, smi,
                        hold=not invariant_changes, frames=frames,
                        bound=None if bf16_held_layers else LM_BF16_RMS,
                        f32_lm=lm if engine_invariant else None)
    say({"phase": phase, "part": "bf16-engine", "arch": arch,
         "reduced": reduced, "dtype": cfg.dtype,
         "capacity_factor": cfg.moe_capacity_factor if cfg.is_moe else None,
         **served,
         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
         "seconds": time.perf_counter() - t0})
    if invariant_changes:
        held = serve_bf16(lm.with_config(cfg.replace(**invariant_changes)),
                          n_requests, rate, smi)
        say({"phase": "lm", "part": "bf16-engine-held", "arch": arch,
             "reduced": reduced, "changes": invariant_changes,
             **{k: held[k] for k in ("served_vs_forward_rms_max",
                                     "served_vs_forward_rms_median", "held",
                                     "bound", "control_other_request",
                                     "served_token_below_top_over_rms",
                                     "decode_ms_median", "card")}})
    t0 = time.perf_counter()
    say({"phase": phase, "part": "decode-profile", "arch": arch,
         "reduced": reduced,
         **profile_decode(lm.with_config(cfg), smi, frames=frames),
         "seconds": time.perf_counter() - t0})
    del lm, f64
    if bf16_held_layers:
        t0 = time.perf_counter()
        cut = LM(cfg.replace(dtype="float32", n_layers=bf16_held_layers),
                 device="cuda")
        cut.init(torch.Generator(device=cut.device).manual_seed(0))
        held = serve_bf16(cut.with_config(cut.cfg.replace(dtype=cfg.dtype)),
                          n_requests, rate, smi, frames=frames,
                          bound=LM_SSM_BF16_RMS, f32_lm=cut)
        say({"phase": phase, "part": "bf16-engine-held", "arch": arch,
             "reduced": {"n_layers": [cfg.n_layers, bf16_held_layers]},
             **{k: held[k] for k in ("served_vs_forward_rms_max",
                                     "served_vs_forward_rms_median", "held",
                                     "bound", "control_other_request",
                                     "bf16_forward_vs_f32_rms_max",
                                     "served_token_below_top_over_rms",
                                     "decode_ms_median", "card")},
             "seconds": time.perf_counter() - t0})
        del cut
    torch.cuda.empty_cache()


def lm_phase(K, smi: str, rate: float) -> None:
    """Phase 17: the LM stack and its engine.  Its matrix products are
    the reference's plain einsums and products, so it launches none of
    the port's kernels: the counters, reset before it, read 0 after."""
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 products are not true float32 here")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    lm_smoke_parity(smi)
    # qwen2.5-14b at full width and depth: 14.77 B parameters, 55 GiB in
    # float32, one copy only
    lm_full_width("qwen2.5-14b", smi, rate, n_requests=8)
    # deepseek-v2-lite at full width, 4 of its 27 layers; the invariant
    # dropless (the reference test's capacity), the engine at the default
    lm_full_width("deepseek-v2-lite-16b", smi, rate, n_layers=4,
                  n_requests=4,
                  invariant_changes={"moe_capacity_factor": 64.0})
    # paligemma-3b at full width and depth, 256 patch embeddings in the
    # invariant; the engine passes none, as the reference's does not
    lm_full_width("paligemma-3b", smi, rate, n_extra=256, n_requests=8)
    launches = K.launch_counts()
    say({"phase": "lm", "part": "launches", "launches": launches,
         "seconds": time.perf_counter() - t0})
    if any(launches.values()):
        raise AssertionError(f"the LM path launched a kernel: {launches}")


# -- the SSM, hybrid and audio families, and training -----------------------

LM_SMOKE_1B = ("mamba2-780m", "zamba2-7b", "whisper-large-v3")
TRAIN_ARCH = "mamba2-780m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_SAVE_AT = 8, 1024, 20, 10
TRAIN_RESUMED = 2      # steps resumed after the step-10 checkpoint
TRAIN_PROFILED = 5     # the loop's step (from 0) traced by torch.profiler
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2      # the reference's lr, a short warm-up
# A resumed step against the uninterrupted run's: the restored state is
# the saved one bit for bit, so only the card's run-to-run rounding may
# differ (the backward's atomic adds); the runs so far read 0.
TRAIN_RESUME_RTOL = 1e-5
# The first step at two microbatches against one: the loss and the global
# gradient norm (readings 0 and 1.7e-7 apart), and the first Adam moment,
# which is the clipped gradient (1 - b1) g min(1, clip / |g|) in bf16:
# the rms of the difference over the rms.  Adam's first update is
# lr g / |g| elementwise, the same size whatever the gradient, so the
# parameters cannot tell a wrong gradient; the moment can.  The first
# microbatch alone is the control the moment's bound must lie below.
TRAIN_MB_RTOL = dict(loss=1e-5, grad_norm=1e-4)
TRAIN_MB_MOMENT = 1e-2
# int8 error feedback's first step: its dequantized gradient plus its
# error buffer against the uncompressed step's gradient (both read back
# from bf16 moments, 2^-9 each), and every element's error within half a
# code of its reference leaf (max|g| / 254, 1% for the bf16 read-back).
TRAIN_EF_RTOL = 1e-2


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` as integers of its width, so ``torch.equal`` compares bits."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def rel_rms(a: dict, b: dict) -> float:
    """The rms of ``a - b`` over the rms of ``b``, over every leaf."""
    num = sum(float((a[k].double() - b[k].double()).pow(2).sum()) for k in b)
    den = sum(float(b[k].double().pow(2).sum()) for k in b)
    return (num / den) ** 0.5


def train_first_steps(cfg, opt, smi: str, loop_first_loss: float) -> None:
    """18c: the first step at one and at two microbatches, with int8 error
    feedback and, as the control, on the first microbatch alone, each
    from the same seeded parameters; held as ``TRAIN_MB_RTOL``,
    ``TRAIN_MB_MOMENT`` and ``TRAIN_EF_RTOL`` say."""
    import numpy as np

    from repro_torch.data import SyntheticTokens
    from repro_torch.models import LM
    from repro_torch.models.convert import reference_key
    from repro_torch.train import build_train_step, init_train_state

    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticTokens(
        vocab=cfg.vocab, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ).batch_at(0).items()}
    half = {k: v[:TRAIN_BATCH // 2] for k, v in batch.items()}
    metrics, grads, err = {}, {}, None
    for name, kw, b in (("microbatches=1", {}, batch),
                        ("microbatches=2", {"microbatches": 2}, batch),
                        ("int8_ef", {"compress": "int8_ef"}, batch),
                        ("first-microbatch-alone", {}, half)):
        lm = LM(cfg, device="cuda").init(
            torch.Generator(device="cuda").manual_seed(0))
        state = init_train_state(lm, opt, compress=kw.get("compress"))
        state, m = build_train_step(lm, opt, **kw)(state, b)
        m = metrics[name] = {k: float(v) for k, v in m.items()}
        # the gradient the optimizer took, read back from the first moment
        unit = (1 - opt.b1) * min(1.0, opt.clip_norm / m["grad_norm"])
        grads[name] = {n: mu.float() / unit
                       for n, mu in state["adam"]["mu"].items()}
        if name == "int8_ef":
            err = state["err"]
        del lm, state
    g = grads["microbatches=1"]
    moment = rel_rms(grads["microbatches=2"], g)
    control = rel_rms(grads["first-microbatch-alone"], g)
    # int8: dequantized + error = the uncompressed gradient, and each
    # element within half a code of its leaf (stacked layers share one)
    ef = metrics["int8_ef"]
    own = {n: grads["int8_ef"][n] + err[n] for n in g}   # its gradient
    telescope = rel_rms(own, g)
    amax, emax = {}, {}
    for n in g:
        k = reference_key(n)[0]
        amax[k] = max(amax.get(k, 0.0), float(own[n].abs().max()))
        emax[k] = max(emax.get(k, 0.0), float(err[n].abs().max()))
    code = max(emax[k] / (amax[k] / 254) for k in amax)
    del grads, err, g, own
    one, two = metrics["microbatches=1"], metrics["microbatches=2"]
    say({"phase": "lm-1b", "part": "c-first-step", "arch": TRAIN_ARCH,
         "metrics": metrics, "first_loss_of_the_loop": loop_first_loss,
         "microbatch_tol_rel": TRAIN_MB_RTOL,
         "moment_mb2_vs_mb1_rel_rms": moment,
         "moment_first_microbatch_alone_rel_rms": control,
         "moment_bound": TRAIN_MB_MOMENT,
         "int8_dequantized_plus_error_vs_grad_rel_rms": telescope,
         "int8_largest_error_over_half_code": code,
         "int8_tol": TRAIN_EF_RTOL, "card": smi})
    for k, tol in TRAIN_MB_RTOL.items():
        if abs(two[k] - one[k]) > tol * abs(one[k]):
            raise AssertionError(f"train: {k} at two microbatches {two[k]} "
                                 f"against {one[k]}")
    if not moment <= TRAIN_MB_MOMENT < control:
        raise AssertionError(f"train: the first moment at two microbatches "
                             f"lies {moment} from one's (bound "
                             f"{TRAIN_MB_MOMENT}, control {control})")
    if not (np.isfinite(ef["loss"]) and 0 < ef["compress_rel_err"] < 0.2
            and telescope <= TRAIN_EF_RTOL
            and code <= 1 + TRAIN_EF_RTOL):
        raise AssertionError(f"train: the int8_ef step {ef}: dequantized "
                             f"+ error {telescope} from the gradient, "
                             f"largest error {code} half-codes")


def train_phase(smi: str, peaks: dict, tmp_dir: str) -> None:
    """18c: mamba2-780m at full width and depth trained through
    ``repro_torch.launch.train.train_loop`` on the card: bf16 compute,
    float32 master weights, AdamW with bf16 moments, global batch 8 x
    1024 tokens from the Philox stream, 20 steps (each timed, one traced),
    an asynchronous checkpoint at step 10 (its host snapshot recorded),
    restored into a separately loaded LM (equal bit for bit) and resumed
    for two steps; the first steps of ``train_first_steps``; ms a step,
    tokens/s and peak memory against the model-FLOP bound."""
    import shutil
    import statistics

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LM
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   load_train_tree, train_tree)

    cfg = configs.get(TRAIN_ARCH)
    opt = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                      warmup_steps=TRAIN_WARMUP)
    run = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, opt=opt,
               log_every=5, device="cuda")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    snapshots, write_s = {}, {}
    times, gaps, traced = [], [], []

    class Recording(launch_train.CheckpointManager):
        """The manager ``train_loop`` uses, recording each host snapshot
        its writer thread is handed and how long the write took."""

        def _save_and_gc(self, step, tree):
            t0 = time.perf_counter()
            snapshots[step] = tree
            super()._save_and_gc(step, tree)
            write_s[step] = time.perf_counter() - t0

    def timing(lm, opt_cfg, **kw):
        """``build_train_step`` whose steps are each timed between
        synchronizes, the host's time between them kept (a checkpoint's
        snapshot lies there), and step ``TRAIN_PROFILED`` traced."""
        step = build(lm, opt_cfg, **kw)
        end = []

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if end:
                gaps.append(t0 - end[-1])
            if len(times) == TRAIN_PROFILED:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = step(state, batch)
                    torch.cuda.synchronize()
                traced.append(prof)
            else:
                out = step(state, batch)
                torch.cuda.synchronize()
            end.append(time.perf_counter())
            times.append(end[-1] - t0)
            return out
        return timed

    ckpt = os.path.join(tmp_dir, "train-ckpt")
    manager, build = launch_train.CheckpointManager, \
        launch_train.build_train_step
    launch_train.CheckpointManager = Recording
    launch_train.build_train_step = timing
    try:
        # 20 uninterrupted steps, saving at step 10 while steps 11-20 run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lm, _, losses = launch_train.train_loop(
            cfg, steps=TRAIN_STEPS, ckpt_dir=ckpt, save_every=TRAIN_SAVE_AT,
            **run)
        loop_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in lm.parameters())
        del lm
        if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
            raise AssertionError(f"train: losses {losses}")
        last5 = float(np.mean(losses[-5:]))
        if not last5 < losses[0]:
            raise AssertionError(f"train: the last five steps' mean loss "
                                 f"{last5} is not below the first's "
                                 f"{losses[0]}")
        # the loop's own steps, but the first (warm-up) and the traced one
        steady = [x for i, x in enumerate(times[:TRAIN_STEPS])
                  if i not in (0, TRAIN_PROFILED)]
        ms = 1e3 * statistics.median(steady)
        profiled = profile_summary(traced.pop(), 1, ms / 1e3, smi)
        flops = 8.0 * n_params * tokens
        bound_ms = flops / peaks["bf16"] * 1e3
        say({"phase": "lm-1b", "part": "c-train", "arch": TRAIN_ARCH,
             "params": n_params, "dtype": cfg.dtype, "remat": cfg.remat,
             "master": "float32", "moments": opt.state_dtype,
             "global_batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "steps": TRAIN_STEPS, "warmup_steps": opt.warmup_steps,
             "losses": losses, "first_loss": losses[0],
             "last5_mean_loss": last5, "ln_vocab": float(np.log(cfg.vocab)),
             "loop_s": loop_s, "loop_ms_per_step": 1e3 * loop_s / TRAIN_STEPS,
             "ms_per_step": ms, "ms_per_step_all": [1e3 * x for x in times],
             "host_ms_between_steps": [1e3 * x for x in gaps],
             "tokens_per_s": tokens / (ms / 1e3),
             "model_flops_per_step": flops,
             "flop_bound": "8 N tokens (forward 2, backward 4, remat 2)",
             "flop_bound_ms": bound_ms, "flop_bound_share": bound_ms / ms,
             "peak_gib": peak / 2**30,
             "checkpoint_write_s": write_s, "card": smi})
        say({"phase": "lm-1b", "part": "c-train-profile", "arch": TRAIN_ARCH,
             "step": TRAIN_PROFILED + 1, **profiled})

        # load step 10 into a separate LM: the tree equals the snapshot
        # the writer was handed, bit for bit; then resume two steps
        shutil.rmtree(os.path.join(ckpt, f"step_{TRAIN_STEPS:08d}"))
        t0 = time.perf_counter()
        at, tree = load_checkpoint(ckpt, device="cuda")
        restored = LM(cfg, device="cuda")
        rstate = init_train_state(restored, opt)
        load_train_tree(restored, rstate, tree)
        load_s = time.perf_counter() - t0
        del tree
        got = dict(cache_leaves(train_tree(restored, rstate)))
        want = dict(cache_leaves(snapshots[TRAIN_SAVE_AT]))
        if at != TRAIN_SAVE_AT or list(got) != list(want) or not all(
                torch.equal(bits(got[k]), bits(want[k])) for k in want):
            raise AssertionError("train: the restored state differs from "
                                 "the saved one")
        n_bytes = sum(v.numel() * v.element_size() for v in want.values())
        nleaves = len(want)
        del got, want, restored, rstate
        snapshots.clear()
        _, _, resumed = launch_train.train_loop(
            cfg, steps=TRAIN_SAVE_AT + TRAIN_RESUMED, ckpt_dir=ckpt,
            resume=True, **run)
        uninterrupted = losses[TRAIN_SAVE_AT:TRAIN_SAVE_AT + TRAIN_RESUMED]
        rel = [abs(a - b) / abs(b) for a, b in zip(resumed, uninterrupted)]
        say({"phase": "lm-1b", "part": "c-checkpoint", "arch": TRAIN_ARCH,
             "saved_at": TRAIN_SAVE_AT, "leaves_bit_equal": nleaves,
             "bytes": n_bytes, "restore_s": load_s,
             "resumed_losses": resumed, "uninterrupted_losses": uninterrupted,
             "resumed_max_rel": max(rel), "tol_rel": TRAIN_RESUME_RTOL,
             "card": smi})
        if len(resumed) != TRAIN_RESUMED or max(rel) > TRAIN_RESUME_RTOL:
            raise AssertionError(f"train: steps {TRAIN_SAVE_AT + 1}-"
                                 f"{TRAIN_SAVE_AT + TRAIN_RESUMED} resumed "
                                 f"differ from the uninterrupted run by "
                                 f"{max(rel)}")
    finally:
        launch_train.CheckpointManager = manager
        launch_train.build_train_step = build
        shutil.rmtree(ckpt, ignore_errors=True)
        snapshots.clear()

    train_first_steps(cfg, opt, smi, losses[0])
    gc.collect()
    torch.cuda.empty_cache()


def lm_1b_phase(K, smi: str, peaks: dict, tmp_dir: str) -> None:
    """Phase 18: the SSM, hybrid and audio families and training, with
    the launch counters reset before and read after (all 0: the SSD is the
    reference's einsums, not the port's scan kernel)."""
    K.reset_launch_counts()
    t0 = time.perf_counter()
    lm_smoke_parity(smi, LM_SMOKE_1B, phase="lm-1b")
    rate = peaks["bytes"]
    # mamba2-780m, 48 layers, d_model 1536, state 128: 0.78 B parameters;
    # its bf16 engine held at 2 layers
    lm_full_width("mamba2-780m", smi, rate, n_requests=8, phase="lm-1b",
                  engine_invariant=True, bf16_held_layers=2)
    # zamba2-7b: 13 groups of 5 SSM blocks and the shared block, 3
    # trailing blocks; 5.74 B parameters, 21.4 GiB in float32; its bf16
    # engine held at 7 blocks (one group, the shared block, one trailing)
    lm_full_width("zamba2-7b", smi, rate, n_requests=8, phase="lm-1b",
                  engine_invariant=True, bf16_held_layers=7)
    # whisper-large-v3: 32 + 32 layers over 1500 seeded frame embeddings
    lm_full_width("whisper-large-v3", smi, rate, n_extra=1500, n_requests=8,
                  phase="lm-1b", engine_invariant=True)
    train_phase(smi, peaks, tmp_dir)
    launches = K.launch_counts()
    say({"phase": "lm-1b", "part": "launches", "launches": launches,
         "seconds": time.perf_counter() - t0})
    if any(launches.values()):
        raise AssertionError(f"the LM-1b path launched a kernel: {launches}")


MODELS_ONLY = ("qwen2.5-14b", "mamba2-780m")   # the driver's CI pair
MODELS_ENTRIES = 51           # the pair's sweep points in the zoo


def models_roster(K, path: str, backend: str, trace_dir: Path, smi: str
                  ) -> tuple[object, dict]:
    """The CI pair's models roster on the card under ``backend``, traced,
    counters set to 0 before and read after: 51/51, each class its port
    pin.  Returns the table and the launches."""
    from repro_torch.suite import SuiteRunner, models_registry

    def drive():
        return SuiteRunner(models_registry(only=MODELS_ONLY, device="cuda"),
                           store=None, sections=("models",),
                           backend=backend).roster()

    with obs_trace(trace_dir, path):
        table, launches, secs = counted(K, drive)
    rep = span_split(trace_dir, path, smi)
    bad = [r["name"] for r in table.records() if not r["match"]]
    say({"phase": "models-roster", "backend": backend,
         "entries": len(table.rows), "matching": len(table.rows) - len(bad),
         "seconds": secs, "capture_s": rep.span_total("capture.model.trace"),
         "walk_s": rep.span_total("capture.walk"),
         "simulation_s": rep.span_total("sim.many"),
         "window_counts": launches[SCAN_KERNEL], "card": smi})
    if len(table.rows) != MODELS_ENTRIES or bad:
        raise AssertionError(f"{path}: {len(table.rows)} entries, "
                             f"divergent {bad}")
    return table, launches


def full_width_step(smi: str) -> None:
    """Part C: qwen2.5-14b at full width and depth, one decode step at bs1
    against a 256-token cache, captured on ``meta``; its census, its dense
    FLOPs within 1% of 2 x (non-embedding parameters + head) + attention's
    4 H D cache L, and a centred 200 000-ref window classified under the
    vectorized and the ``cuda`` backend with equal rows."""
    from repro_torch.capture import zoo
    from repro_torch.core import classify
    from repro_torch.core.tracegen import TraceSpec, Workload
    from repro_torch.study.study import Study

    t0 = time.perf_counter()
    lm = zoo.meta_lm("qwen2.5-14b", smoke=False)
    mc = zoo.capture_decode(lm, 1, 256, name="qwen2.5-14b.full.decode.bs1")
    capture_s = time.perf_counter() - t0
    census = zoo.census(mc)
    cfg = lm.cfg
    hd = cfg.resolved_head_dim
    params = cfg.n_layers * (cfg.d_model * cfg.n_heads * hd
                             + 2 * cfg.d_model * cfg.n_kv_heads * hd
                             + cfg.n_heads * hd * cfg.d_model
                             + 3 * cfg.d_model * cfg.d_ff) \
        + cfg.d_model * cfg.vocab
    analytic = 2.0 * params + 4.0 * cfg.n_heads * hd * 256 * cfg.n_layers
    dense = sum(op.capture.flops for op in mc.ops if op.kind == "dense")
    t1 = time.perf_counter()
    addr = mc.walk_window(200_000).addresses
    window_s = time.perf_counter() - t1
    ai = round(mc.flops / census[5], 3)
    w = Workload(name="model.qwen2.5-14b.full.decode.bs1", family="model",
                 expected_class="1b", ai_ops_per_access=ai,
                 instr_per_access=ai + 2.0,
                 gen=lambda cores, rng: TraceSpec(addr, 1.0, 8.0, False),
                 core_invariant=True)
    rows = {}
    for backend in ("vectorized", "cuda"):
        m = Study(suite=[w], backend=backend).metrics(w)
        rows[backend] = (classify.classify(m), m.temporal, m.spatial,
                         m.mpki, m.lfmr_by_cores)
    say({"phase": "models-full-width", "model": "qwen2.5-14b",
         "layers": cfg.n_layers, "d_model": cfg.d_model,
         "ops": mc.op_kinds, "footprint_mib": census[4],
         "whole_refs": census[5], "flops": mc.flops, "dense_flops": dense,
         "analytic_flops": analytic, "ai": ai, "capture_s": capture_s,
         "window_s": window_s, "class": rows["cuda"][0],
         "mpki": rows["cuda"][3], "card": smi})
    if abs(dense - analytic) > 0.01 * analytic:
        raise AssertionError(f"full-width dense FLOPs {dense:.4e} not "
                             f"within 1% of {analytic:.4e}")
    if rows["vectorized"] != rows["cuda"]:
        raise AssertionError(f"full-width window: {rows}")


def models_phase(K, trace_dir: Path, smi: str) -> dict[str, dict]:
    """Phase 19, the whole-model capture and zoo on the card: (a) one
    smoke decode step captured with its LM on the card and on ``meta``
    (equal ops, FLOPs and walk); (b) the CI pair's models roster under the
    vectorized and the ``cuda`` backend (51/51, each class its pin, rows
    equal, window counts launched under cuda); (c) the driver's
    ``models_sweep`` under both (equal rows, ``capture.model.concat``
    0, the counter gate of ``perf_gate``); (d) Part C's full-width step.
    Returns each path's launches."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.benchmarks import perf_gate
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.capture import zoo
    from repro_torch.models.model import LM

    t_phase = time.perf_counter()
    # (a) the same step on the card and on meta
    name = "qwen2.5-14b"
    lm = LM(configs.get_smoke(name), device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    card = zoo.capture_decode(lm, 2, 256, name="card")
    meta = zoo.capture_decode(zoo.meta_lm(name), 2, 256, name="meta")
    same_ops = [(o.kind, o.capture.name, o.capture.grid, o.bases)
                for o in card.ops] == [(o.kind, o.capture.name,
                                        o.capture.grid, o.bases)
                                       for o in meta.ops]
    same_walk = np.array_equal(card.walk().addresses, meta.walk().addresses)
    say({"phase": "models-card-vs-meta", "entry": f"{name}.decode.bs2",
         "ops": len(card.ops), "equal_ops": same_ops,
         "equal_walk": same_walk, "flops": [card.flops, meta.flops]})
    if not (same_ops and same_walk and card.flops == meta.flops
            and card.footprint_words == meta.footprint_words):
        raise AssertionError("the card's capture differs from meta's")
    del lm, card, meta

    # (b) the models roster, vectorized then cuda
    vec, vec_launches = models_roster(K, "models-vectorized", "vectorized",
                                      trace_dir, smi)
    cud, cuda_launches = models_roster(K, "models-cuda", "cuda", trace_dir,
                                       smi)
    if vec.rows != cud.rows:
        raise AssertionError("models roster: cuda rows differ from the "
                             "vectorized backend's")
    if vec_launches[SCAN_KERNEL] or cuda_launches[SCAN_KERNEL] <= 0:
        raise AssertionError(f"models roster window counts: "
                             f"{vec_launches[SCAN_KERNEL]} vectorized, "
                             f"{cuda_launches[SCAN_KERNEL]} cuda")

    # (c) models_sweep: the streamed step under both backends
    sweep, sweep_launches = {}, {}
    for backend in (None, "cuda"):
        label = f"models-sweep-{backend or 'default'}"
        argv = ["--device", "cuda", "--only", "models_sweep",
                "--bench-json", ""]
        if backend:
            argv += ["--backend", backend]
        args = bench_run.build_parser().parse_args(argv)
        with obs_trace(trace_dir, label), \
                contextlib.redirect_stdout(sys.stderr):
            res, launches, secs = counted(K, lambda: bench_run.run(args))
        rep = span_split(trace_dir, label, smi)
        sweep[backend] = res["sections"]["models_sweep"]["rows"]
        sweep_launches[backend] = launches
        gate_rc = perf_gate.main(["--obs-trace",
                                  str(trace_dir / f"{label}.jsonl"),
                                  "--obs-require",
                                  "capture.model.concat==0",
                                  "--obs-require",
                                  "capture.model.stream_blocks>0"])
        say({"phase": "models-sweep", "backend": backend or "default",
             "seconds": secs, "rows": sweep[backend],
             "concat": rep.counter("capture.model.concat"),
             "stream_blocks": rep.counter("capture.model.stream_blocks"),
             "window_counts": launches[SCAN_KERNEL], "gate_rc": gate_rc,
             "card": smi})
        if gate_rc:
            raise AssertionError(f"{label}: the counter gate failed")
    if sweep[None] != sweep["cuda"] or sweep_launches["cuda"][
            SCAN_KERNEL] <= 0:
        raise AssertionError(f"models_sweep: {sweep}")

    # (d) the full-width step
    full_width_step(smi)
    say({"phase": "models", "seconds": time.perf_counter() - t_phase,
         "card": smi})
    return {"models": cuda_launches, "models_sweep": sweep_launches["cuda"]}


def gates_phase(smi: str, tmp_dir: str) -> None:
    """The port's CI gates on the card: ``timing_smoke`` (a cold 250k-ref
    cell per family under 2 s, vectorized and cuda) and ``perf_gate``: a
    fresh ``python -m repro_torch.benchmarks.run --fast`` on the card
    against the committed ``baseline_h100.json``, and its models_sweep
    counter gate."""
    from repro_torch.benchmarks import timing_smoke

    t0 = time.perf_counter()
    times = timing_smoke.time_cells(("vectorized", "cuda"))
    rc = timing_smoke.verdict(times, ("vectorized", "cuda"), budget=2.0,
                              compare=False, out=sys.stderr)
    say({"phase": "timing-smoke", "rc": rc, "cells_s": times,
         "seconds": time.perf_counter() - t0, "card": smi})
    if rc:
        raise AssertionError("timing_smoke failed")
    record = Path(tmp_dir) / "bench-fast.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_SUITE_STORE=str(Path(tmp_dir) / "bench-store"))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--fast",
         "--bench-json", str(record)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    driver_s = time.perf_counter() - t0
    if run.returncode:
        raise AssertionError(f"the fast driver failed: {run.stderr[-2000:]}")
    gate = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.perf_gate",
         "--current", str(record)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    (bucket,) = json.loads(record.read_text())["runs"].values()
    say({"phase": "perf-gate", "rc": gate.returncode,
         "driver_s": driver_s, "sections": bucket["sections"],
         "meta": bucket["meta"], "report": gate.stdout.splitlines(),
         "verdict": gate.stderr.strip().splitlines()[-1:], "card": smi})
    if gate.returncode:
        raise AssertionError(f"perf_gate failed: {gate.stderr[-2000:]}")


LAUNCH_CELLS = (("qwen2.5-14b", "decode_32k", True),
                ("deepseek-moe-16b", "train_4k", False),
                ("mamba2-780m", "prefill_32k", False))
CARD_GB = 80


def cell_arg_bytes(arch: str) -> int:
    """The argument bytes a card of a ``LAUNCH_CELLS`` cell, from the
    published widths and the mesh arithmetic written out here, not from
    the port's sharding rules: serving keeps bf16 weights sharded over
    "model" (16) alone, training f32 weights also over the data axes
    (FSDP) with bf16 AdamW moments and an int32 step count; a dimension
    splits only where the mesh axis divides it."""
    i32, bf16, f32 = 4, 2, 4
    if arch == "qwen2.5-14b":
        # Qwen2.5-14B: 48 layers, d 5120, 40 query / 8 kv heads of 128,
        # d_ff 13824, vocab 152064, qkv biases; decode_32k, batch 128 x
        # 32768 on 2x16x16: model 16, batch over pod x data = 32
        n_l, d, h, g, hd, ff, v = 48, 5120, 40, 8, 128, 13824, 152064
        model, data = 16, 32
        # 40 and 8 heads do not split 16 ways: attention whole on each card
        attn = 2 * d * h * hd + 2 * d * g * hd + h * hd + 2 * g * hd
        mlp = 3 * d * ff // model                   # 13824 = 16 x 864
        params = n_l * (attn + mlp + 2 * d) + 2 * v * d // model + d
        # k and v: batch over pod x data, length over model (flash-decode)
        cache = 2 * n_l * (128 // data) * (32768 // model) * g * hd
        return bf16 * (params + cache) + i32 * 2 * (128 // data)
    if arch == "deepseek-moe-16b":
        # DeepSeek-MoE-16B: 28 layers, d 2048, 16 heads of 128, 64 routed
        # experts of 1408 and 2 shared, vocab 102400; train_4k, batch 256
        # x 4096 on 16x16: FSDP over data 16, heads/experts/ffn/vocab over
        # model 16, the router [d, 64] over data alone, norms whole
        n_l, d, h, hd, e, ff, v = 28, 2048, 16, 128, 64, 1408, 102400
        model, data = 16, 16
        both = model * data
        layer = (4 * d * h * hd // both + d * e // data
                 + 3 * e * d * ff // both + 3 * d * 2 * ff // both + 2 * d)
        params = n_l * layer + 2 * v * d // both + d
        return (f32 + 2 * bf16) * params + i32 + i32 * 2 * (256 // data) * 4096
    if arch == "mamba2-780m":
        # Mamba2-780m: 48 layers, d 1536, d_inner 3072, state 128, heads
        # of 64, conv 4, vocab 50280 tied; prefill_32k, batch 32 x 32768
        # on 16x16: model 16, batch over data 16
        n_l, d, di, n, hp, k, v = 48, 1536, 3072, 128, 64, 4, 50280
        model, data = 16, 16
        h, ch = di // hp, di + 2 * n
        layer = (d * (2 * di + 2 * n + h) // model    # 6448 = 16 x 403
                 + k * ch + ch                         # the conv, whole
                 + 3 * h // model + di // model + di * d // model + d)
        # 50280 vocab rows do not split 16 ways: the embedding whole
        params = n_l * layer + v * d + d
        state = n_l * (32 // data) * (h // model) * n * hp
        conv = n_l * (32 // data) * (k - 1) * (ch // model)
        return (bf16 * params + f32 * state + bf16 * conv
                + i32 * (32 // data) * 32768)
    raise KeyError(arch)


def launch_phase(smi: str, tmp_dir: str) -> None:
    """Phase 20: the ``hlo`` substrate on ``H100_SXM``, three full-width
    dry-run cells in child processes, and one placed decode cell stepped
    on the card against the plain LM and its bound."""
    import statistics

    from repro_torch.core import analytic, hlo_analysis
    from repro_torch.launch.cells import plan_for
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import build_cell, plain_lm
    from repro_torch.models.config import SHAPES
    from repro_torch.study.substrate import HloSubstrate

    t_phase = time.perf_counter()
    # (a) the hlo substrate's rows
    t0 = time.perf_counter()
    res = HloSubstrate().characterize()
    hlo_s = time.perf_counter() - t0
    classes: dict[str, int] = {}
    for row in res.to_rows():
        classes[row[1]] = classes.get(row[1], 0) + 1
    say({"phase": "launch-hlo", "rows": len(res.to_rows()),
         "classes": classes, "hw": hlo_analysis.H100_SXM.name,
         "seconds": hlo_s})
    if len(res.to_rows()) != 64:
        raise AssertionError(f"hlo substrate: {len(res.to_rows())} rows")

    # (b) three full-width dry-run cells, one child process each
    out_dir = Path(tmp_dir) / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = []
    for arch, shape, mp in LAUNCH_CELLS:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape, "--out", str(out_dir)]
        procs.append(subprocess.Popen(
            argv + (["--multi-pod"] if mp else []), env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=900) for p in procs]
    dry_s = time.perf_counter() - t0
    for (arch, shape, mp), p, (out, err) in zip(LAUNCH_CELLS, procs, outs):
        tag = f"{arch}__{shape}__{'2pod' if mp else '1pod'}"
        path = out_dir / f"{tag}.json"
        if p.returncode or not path.exists():
            raise AssertionError(f"dry run {tag}: rc {p.returncode}: "
                                 f"{err[-2000:]}")
        e = json.loads(path.read_text())
        if e["status"] != "ok":
            raise AssertionError(f"dry run {tag}: {e.get('error')}: "
                                 f"{e.get('traceback', '')[-1500:]}")
        m = e["memory"]
        want = cell_arg_bytes(arch)
        say({"phase": "launch-dryrun", "cell": f"{arch}:{shape}",
             "mesh": e["mesh"], "chips": e["chips"],
             "arg_gb": m["argument_size_in_bytes"] / 1e9,
             "temp_gb": m["temp_size_in_bytes"] / 1e9,
             "out_gb": m["output_size_in_bytes"] / 1e9, "card_gb": CARD_GB,
             "fits": (m["argument_size_in_bytes"]
                      + m["temp_size_in_bytes"]) / 1e9 <= CARD_GB,
             "arg_bytes_expected": want,
             "collective_bytes": e["hlo_collective_bytes_per_iter"],
             "collective_by_op": e["hlo_collective_by_op"],
             "local_flops": e["hlo_cost_analysis"]["flops"],
             "local_bytes": e["hlo_cost_analysis"]["bytes accessed"],
             "ops": e["hlo_ops"], "class": e["class"],
             "place_s": e["lower_s"], "step_s": e["compile_s"]})
        if m["argument_size_in_bytes"] != want:
            raise AssertionError(f"dry run {tag}: argument bytes "
                                 f"{m['argument_size_in_bytes']} != {want}")
        if not e["hlo_collective_bytes_per_iter"]:
            raise AssertionError(f"dry run {tag}: no collective recorded")

    # (c) one placed cell on the card against the plain LM
    plan = plan_for("mamba2-780m", "decode_32k")
    cfg = plan.cfg
    with make_local_mesh() as mesh:
        t0 = time.perf_counter()
        fn, args, _, _, _ = build_cell(plan, mesh)
        params, tokens, cache, pos = args
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0

        def local(tree):
            if isinstance(tree, dict):
                return {k: local(v) for k, v in tree.items()}
            return tree.to_local()

        plain = plain_lm(cfg, params, "cuda")
        plain_cache = {k: {n: t.clone() for n, t in v.items()}
                       for k, v in local(cache).items()}
        state_gb = sum(t.numel() * t.element_size() for v in
                       plain_cache.values() for t in v.values()) / 1e9
        with torch.no_grad():
            want, want_cache = plain.decode_step(tokens.to_local(),
                                                 plain_cache,
                                                 pos.to_local())
            got, got_cache = fn(*args)
        got = got.to_local()
        torch.cuda.synchronize()
        # the logits and every cache leaf the step wrote (the SSM state
        # and conv rows, through the mesh's copy_into), each against its
        # own rms
        pairs = {"logits": (got, want)}
        for k in want_cache:
            for n, a in local(got_cache)[k].items():
                pairs[f"{k}.{n}"] = (a, want_cache[k][n])
        errs, rmss = {}, {}
        for n, (a, b) in pairs.items():
            errs[n] = float((a.float() - b.float()).abs().max())
            rmss[n] = float(b.float().pow(2).mean().sqrt())
        err, rms = errs["logits"], rmss["logits"]
        bit_equal = all(torch.equal(a, b) for a, b in pairs.values())
        del pairs
        del plain, plain_cache, want, want_cache, got, got_cache
        torch.cuda.empty_cache()
        times = []
        with torch.no_grad():
            for _ in range(5):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
        del fn, args, params, tokens, cache, pos
    gc.collect()
    torch.cuda.empty_cache()
    c = analytic.cell_cost(cfg, SHAPES["decode_32k"], kind="decode",
                           microbatches=1, data_shards=1, model_shards=1)
    rt = hlo_analysis.RooflineTerms(
        name="mamba2-780m:decode_32k@1", chips=1, hlo_flops=c.flops,
        hlo_bytes=c.hbm_bytes, collective_bytes=c.collective_bytes,
        hw=hlo_analysis.H100_SXM)
    ms = statistics.median(times)
    say({"phase": "launch-card-cell", "cell": plan.name,
         "layers": cfg.n_layers, "batch": plan.shape.global_batch,
         "cache_gb": state_gb, "place_s": place_s,
         "bit_equal": bit_equal, "max_abs_err": err, "logits_rms": rms,
         "leaf_max_abs_err": errs, "leaf_rms": rmss,
         "step_ms": times, "median_ms": ms,
         "bound_ms": rt.t_bound * 1e3, "bound_by": rt.dominant,
         "ratio": ms / (rt.t_bound * 1e3), "card": smi})
    bad = {n: (errs[n], rmss[n]) for n in errs
           if not errs[n] <= 1e-5 * rmss[n]}
    if bad:
        raise AssertionError(f"placed decode step: max |diff| over 1e-5 x "
                             f"rms in {bad}")
    say({"phase": "launch", "dryrun_s": dry_s,
         "seconds": time.perf_counter() - t_phase, "card": smi})


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
    from repro_torch.benchmarks.kernel_bench import (CardBench, card_identity,
                                                     card_peaks, stream_calls)
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
    smi = ", ".join(card_identity())   # nvidia-smi's csv line
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
    bench = CardBench(peaks)

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
        for op, (entry, plain, _, lib) in streams.items():
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
    geometry_timings(CardBench(peaks), smi, launched + served)
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
        roster_calls + sections_calls, smi, CardBench(peaks), errs)
    del roster_calls, sections_calls
    torch.cuda.empty_cache()

    # -- 15. simulate_chunked over a megaref trace on the card's host -------
    megaref_host = megaref_phase(K, smi)

    # -- 16. main paths 8-9: the benchmark driver's sections under both
    # backends, and the study CLI --------------------------------------------
    figures_launches, figures_cuda_launches = figures_phase(
        K, trace_dir, smi, roster.rows, megaref_host, errs)
    del megaref_host

    # -- 17. the LM stack and its serving engine (after the earlier phases
    # let go of the card's memory) ----------------------------------------
    del launched, served, registry, cpu_registry, runner, roster, timelines
    forget_captures()
    gc.collect()
    torch.cuda.empty_cache()
    say({"phase": "lm", "part": "memory-before",
         "allocated_gib": torch.cuda.memory_allocated() / 2**30,
         "reserved_gib": torch.cuda.memory_reserved() / 2**30})
    lm_phase(K, smi, peaks["bytes"])

    # -- 18. the SSM, hybrid and audio families, and training ---------------
    gc.collect()
    torch.cuda.empty_cache()
    lm_1b_phase(K, smi, peaks, tmp.name)

    # -- 19. the whole-model capture and zoo, then the CI gates -------------
    gc.collect()
    torch.cuda.empty_cache()
    models_launches = models_phase(K, trace_dir, smi)
    gates_phase(smi, tmp.name)

    # -- 20. the cost substrate and the launch layer --------------------------
    gc.collect()
    torch.cuda.empty_cache()
    launch_phase(smi, tmp.name)

    # -- 21. results --------------------------------------------------------
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
                "sections_cuda": sections_cuda_launches[kname],
                "figures": figures_launches[kname],
                "figures_cuda": figures_cuda_launches[kname],
                "models": models_launches["models"][kname],
                "models_sweep": models_launches["models_sweep"][kname]},
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
