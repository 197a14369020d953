"""Captured-kernel workloads: real launches -> ``Workload``
(counterpart of ``repro.capture.kernels``).

Each entry runs a kernel capture hook (``repro_torch.kernels.*.capture``),
which launches the kernel on the requested device and walks the launched
spec into an HBM word-address stream, and wraps the stream as a
:class:`repro_torch.core.tracegen.Workload` for the unchanged Step-2/3
pipeline (locality, cache simulation, classification).  It holds the
reference's six families, all 24 entries, with the reference's names,
order and geometry: STREAM copy/scale/add/triad x2 sizes, token_gather x2
tables, flash_attention x2 KV geometries, paged-KV decode x4, MoE dispatch
x4, SSM scans x4.

Modeling notes (as in the reference):

- Traces are *per-thread*: hooks partition the kernel's grid the way the
  kernel is parallelized (row tiles for STREAM, index slices for gather,
  q- or kv-splits for attention, one sequence per thread for decode, a
  token slice for MoE dispatch, a time slice for the SSM scans).
- Per-thread traces are length-normalized to ``target_refs`` by cycling
  (``np.resize``) when it is set.
- AI comes from the capture's op count over its 1-core stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.tracegen import TraceSpec, Workload
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import capture as flash_capture
from repro_torch.kernels.moe_dispatch import capture as moe_capture
from repro_torch.kernels.paged_kv_decode import capture as paged_capture
from repro_torch.kernels.ssm_scan import capture as ssm_capture
from repro_torch.kernels.stream import capture as stream_capture
from repro_torch.kernels.token_gather import capture as gather_capture

from .grid import GridCapture, walk

__all__ = ["CapturedKernel", "CAPTURED_KERNELS", "captured_workloads"]

Builder = Callable[[int, np.random.Generator, torch.device], GridCapture]


@dataclass(frozen=True)
class CapturedKernel:
    """Declaration of one captured-kernel suite entry."""

    name: str
    kernel: str                 # "stream" | "gather" | "flashattn" | ...
    domain: str
    expected_class: str
    target_refs: int            # per-thread trace length after cycling (0: raw)
    l3_shared: bool             # True -> l3_factor 1.0; False -> 1/cores
    mlp: float
    dram_rows_irregular: bool
    instr_overhead: float       # instructions per ref beyond arithmetic ops
    builder: Builder            # (cores, rng, device) -> per-thread geometry
    geometry: tuple[tuple[str, object], ...] = ()
    # True when the per-thread trace and l3_factor ignore the core count.
    core_invariant: bool = False

    def params(self) -> dict:
        """The suite registry's parameters of this entry: part of its store
        fingerprint, so a geometry edit invalidates stored rows."""
        return {
            "kernel": self.kernel,
            "target_refs": self.target_refs,
            "l3": "shared" if self.l3_shared else "partitioned",
            "mlp": self.mlp,
            **dict(self.geometry),
        }


def _stream_builder(op: str, n_elems: int) -> Builder:
    def build(cores, rng, device):
        del rng  # STREAM is index-free
        return stream_capture.capture(op, n_elems, cores=cores, device=device)
    return build


def _gather_builder(n_rows: int, d: int, m: int) -> Builder:
    def build(cores, rng, device):
        del cores  # thread-private slice of the global index stream
        return gather_capture.capture(n_rows, d, m, rng=rng, device=device)
    return build


def _flash_builder(sq: int, sk: int, d: int, partition: str) -> Builder:
    def build(cores, rng, device):
        del rng  # dense attention: no data-dependent addressing
        return flash_capture.capture(sq=sq, sk=sk, d=d, cores=cores,
                                     partition=partition, device=device)
    return build


def _paged_builder(n_pages: int, page: int, d: int, h: int,
                   n_active: int) -> Builder:
    def build(cores, rng, device):
        del cores  # one decode sequence per thread over the shared pool
        return paged_capture.capture(n_pages=n_pages, page=page, d=d, h=h,
                                     n_active=n_active, rng=rng,
                                     device=device)
    return build


def _moe_builder(n_tokens: int, d: int, f: int, n_experts: int) -> Builder:
    def build(cores, rng, device):
        del cores  # thread-private token slice over the shared expert table
        return moe_capture.capture(n_tokens=n_tokens, d=d, f=f,
                                   n_experts=n_experts, rng=rng,
                                   device=device)
    return build


def _ssm_builder(op: str, seq_len: int, d: int, n: int,
                 chunk: int) -> Builder:
    def build(cores, rng, device):
        del rng  # dense scan: no data-dependent addressing
        return ssm_capture.capture(op, seq_len=seq_len, d=d, n=n,
                                   chunk=chunk, cores=cores, device=device)
    return build


def _stream_entries() -> list[CapturedKernel]:
    out = []
    for op in ("copy", "scale", "add", "triad"):
        for tag, n_elems in (("1MiB", 2**18), ("2MiB", 2**19)):
            geo = dict(op=op, n_elems=n_elems)
            out.append(CapturedKernel(
                name=f"pal.stream.{op}.{tag}",
                kernel="stream",
                domain="TPU-kernel/streaming",
                expected_class="1a",
                target_refs=0,
                l3_shared=True,
                mlp=8.0,
                dram_rows_irregular=False,
                instr_overhead=2.0,
                builder=_stream_builder(**geo),
                geometry=tuple(sorted(geo.items())),
            ))
    return out


_GEO_GATHER = (
    ("64kx128", dict(n_rows=65536, d=128, m=2048)),
    ("16kx256", dict(n_rows=16384, d=256, m=1024)),
)


def _gather_entries() -> list[CapturedKernel]:
    return [
        CapturedKernel(
            name=f"pal.gather.{tag}",
            kernel="gather",
            domain="TPU-kernel/sparse",
            expected_class="1a",
            target_refs=0,
            l3_shared=True,
            mlp=6.0,
            dram_rows_irregular=True,
            instr_overhead=3.0,
            builder=_gather_builder(**geo),
            geometry=tuple(sorted(geo.items())),
            core_invariant=True,
        )
        for tag, geo in _GEO_GATHER
    ]


# Shared-KV (q-partitioned): KV streamed per invocation at reuse distances
# beyond every cache a thread holds -> latency-class 1b.  kv-split: the
# per-core KV chunk shrinks with the core count until it fits the private
# L2, so LFMR collapses -> 1c.
_GEO_FLASH = (
    ("d128.kv2k", "1b", 300_000, True,
     dict(sq=256, sk=2048, d=128, partition="q")),
    ("d64.kv20k", "1c", 600_000, False,
     dict(sq=256, sk=20480, d=64, partition="kv")),
)


def _flash_entries() -> list[CapturedKernel]:
    return [
        CapturedKernel(
            name=f"pal.flashattn.{tag}",
            kernel="flashattn",
            domain="TPU-kernel/attention",
            expected_class=cls,
            target_refs=refs,
            l3_shared=shared,
            mlp=4.0,
            dram_rows_irregular=False,
            instr_overhead=2.0,
            builder=_flash_builder(**geo),
            geometry=tuple(sorted(geo.items())),
        )
        for tag, cls, refs, shared, geo in _GEO_FLASH
    ]


# Paged-KV decode: the GQA group width h decides the class.  MQA decode
# moves ~4 ops per word over the randomly-paged pool (1a); a group of 4-8
# heads multiplies arithmetic per fetched page, collapsing MPKI while the
# page walk stays reuse-free -> latency-bound (1b).
_GEO_PAGED = (
    ("mqa.p32", "1a", dict(n_pages=8192, page=32, d=128, h=1, n_active=64)),
    ("gqa8.p32", "1b", dict(n_pages=8192, page=32, d=128, h=8, n_active=64)),
    ("mqa.p64", "1a", dict(n_pages=4096, page=64, d=128, h=1, n_active=32)),
    ("gqa4.p16", "1b", dict(n_pages=16384, page=16, d=128, h=4,
                            n_active=128)),
)


def _paged_entries() -> list[CapturedKernel]:
    return [
        CapturedKernel(
            name=f"pal.pagedkv.{tag}",
            kernel="pagedkv",
            domain="TPU-kernel/serving-paged-kv",
            expected_class=cls,
            target_refs=0,
            l3_shared=True,
            mlp=6.0,
            dram_rows_irregular=True,
            instr_overhead=2.0,
            builder=_paged_builder(**geo),
            geometry=tuple(sorted(geo.items())),
            core_invariant=True,
        )
        for tag, cls, geo in _GEO_PAGED
    ]


# MoE dispatch: the tokens-per-expert ratio decides the class.  Cold
# experts (~1 token each) stream the whole weight table per batch at ~6
# ops/word (1a); long sorted runs amortize each weight tile over many
# tokens, leaving the irregular activation gather/scatter (1b).
_GEO_MOE = (
    ("cold.64e", "1a", dict(n_tokens=64, d=128, f=128, n_experts=64)),
    ("cold.96e", "1a", dict(n_tokens=96, d=128, f=128, n_experts=96)),
    ("warm.8e", "1b", dict(n_tokens=512, d=128, f=256, n_experts=8)),
    ("warm.32e", "1b", dict(n_tokens=256, d=128, f=128, n_experts=32)),
)


def _moe_entries() -> list[CapturedKernel]:
    return [
        CapturedKernel(
            name=f"pal.moe.{tag}",
            kernel="moe",
            domain="TPU-kernel/moe-dispatch",
            expected_class=cls,
            target_refs=0,
            l3_shared=True,
            mlp=8.0,
            dram_rows_irregular=False,
            instr_overhead=3.0,
            builder=_moe_builder(**geo),
            geometry=tuple(sorted(geo.items())),
            core_invariant=True,
        )
        for tag, cls, geo in _GEO_MOE
    ]


# SSM scans: the state never touches HBM, so the trace is pure
# chunk-granular streaming.  The gated EMA scan moves ~3 ops per word
# (1a); the state-expanded (n=128) scan retires two chunk-local matmuls
# per block and profiles as compute-heavy streaming (1b).
_GEO_SSM = (
    ("ema.1k.d128", "1a", dict(op="ema", seq_len=1024, d=128, n=0,
                               chunk=128)),
    ("ema.512.d256", "1a", dict(op="ema", seq_len=512, d=256, n=0,
                                chunk=64)),
    ("expand.512.d128", "1b", dict(op="expand", seq_len=512, d=128, n=128,
                                   chunk=128)),
    ("expand.512.d256", "1b", dict(op="expand", seq_len=512, d=256, n=128,
                                   chunk=64)),
)


def _ssm_entries() -> list[CapturedKernel]:
    return [
        CapturedKernel(
            name=f"pal.ssm.{tag}",
            kernel="ssm",
            domain="TPU-kernel/ssm-scan",
            expected_class=cls,
            target_refs=0,
            l3_shared=True,
            mlp=8.0,
            dram_rows_irregular=False,
            instr_overhead=2.0,
            builder=_ssm_builder(**geo),
            geometry=tuple(sorted(geo.items())),
        )
        for tag, cls, geo in _GEO_SSM
    ]


CAPTURED_KERNELS: tuple[CapturedKernel, ...] = tuple(
    _stream_entries() + _gather_entries() + _flash_entries()
    + _paged_entries() + _moe_entries() + _ssm_entries()
)


def _make_gen(spec: CapturedKernel, device: torch.device):
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        addr = walk(spec.builder(cores, rng, device)).addresses
        if spec.target_refs and addr.size != spec.target_refs:
            addr = np.resize(addr, spec.target_refs)
        return TraceSpec(
            addresses=addr,
            l3_factor=1.0 if spec.l3_shared else 1.0 / max(1, cores),
            mlp=spec.mlp,
            dram_rows_irregular=spec.dram_rows_irregular,
        )
    return gen


def captured_workloads(
    specs: tuple[CapturedKernel, ...] = CAPTURED_KERNELS,
    *,
    device: str | torch.device = "cuda",
) -> list[Workload]:
    """Wrap every captured kernel as a pipeline-ready ``Workload`` whose
    traces come from launches on ``device``.

    AI is the capture's op count over its 1-core stream (a count-only walk
    of the launch at one core and a fixed rng stream).
    """
    dev = resolve_device(device)
    out: list[Workload] = []
    for spec in specs:
        ref = walk(spec.builder(1, np.random.default_rng(0), dev),
                   count_only=True)
        ai = round(ref.flops_per_ref, 3)
        out.append(Workload(
            name=spec.name,
            family=f"pallas-{spec.kernel}",
            expected_class=spec.expected_class,
            ai_ops_per_access=ai,
            instr_per_access=round(ai + spec.instr_overhead, 3),
            gen=_make_gen(spec, dev),
            core_invariant=spec.core_invariant,
        ))
    return out
