"""DAMOV Step 3 re-based onto the dry run's op record (the port of
``repro.core.hlo_analysis``).

The paper classifies functions by *where their data movement stalls* using
architecture-dependent metrics gathered from simulation.  The reference
reads them from a compiled XLA module; the port has no HLO, and the dry
run's record of dispatched ops stands in for it
(``repro_torch.launch.dryrun``): the cell's step runs once on ``meta``
DTensors over a fake process group under a ``TorchDispatchMode`` that sees
every local op and every collective that sharding propagation inserts.

- the local ops' FLOPs and operand + result bytes -> compute/memory terms
  (the reference's ``cost_analysis()``)
- each collective's op name and local result bytes -> the interconnect
  term (the reference parses them from the optimized HLO text)

From these come the three roofline terms per (arch × shape × mesh) cell
and a DAMOV-style bottleneck class:

=================  ==========================================================
class              DAMOV analogue
=================  ==========================================================
``compute``        Class 2c (compute-bound: the tensor-core roof dominates)
``hbm``            Class 1a (DRAM-bandwidth-bound: the HBM roof dominates)
``collective``     off-chip-link bound (the paper's I/O-pin argument, §1) —
                   mitigated by compute-near-shard placement, the cluster-
                   scale analogue of NDP
``latency``        Class 1b (small grids: per-op dispatch latency, not any
                   throughput roof, dominates)
=================  ==========================================================

The card is the H100 SXM (``H100_SXM``).  Its one link term is NVLink's
rate inside one 8-card NVLink domain; a mesh wider than that crosses
InfiniBand between hosts, which this one-bandwidth term does not model
(the reference's ICI term does not model DCN between pods either).

The module also reports the paper's "useful-compute" hygiene ratio
MODEL_FLOPS / step FLOPs (catching remat/redundant recompute) and the
arithmetic intensity, FLOPs per HBM byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "H100_SXM",
    "HardwareSpec",
    "CollectiveStats",
    "RooflineTerms",
    "COLLECTIVE_NAMES",
    "collective_stats",
    "roofline",
    "dtype_bytes",
]


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link
    vmem_bytes: int = 128 * 2**20
    dispatch_latency_s: float = 3e-6   # per executed op "step" floor


# NVIDIA H100 SXM5 80GB at 700 W, from NVIDIA's data sheet:
# - peak_flops: 989 TFLOP/s bf16 dense tensor-core (kernel_bench.PEAKS);
# - hbm_bw: 3.35 TB/s HBM3;
# - ici_bw: 450 GB/s, NVLink 4 per direction per card (900 GB/s both ways);
# - vmem_bytes: the 50 MB L2, the nearest the card has to VMEM;
# - dispatch_latency_s: the reference's per-op floor, kept as it is.
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    vmem_bytes=50 * 2**20,
)

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e4m3": 1, "f8e5m2fnuz": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# ``c10d_functional`` op -> the reference's collective name.  The
# point-to-point ops (``send``, ``recv``, ``permute_tensor``'s ``send``/
# ``recv`` pairs) are the HLO's collective-permute.
COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "recv": "collective-permute",
    "permute_tensor": "collective-permute",
}


def dtype_bytes(dt) -> int:
    """Bytes of one element: an HLO dtype name (``"bf16"``) or a
    ``torch.dtype``."""
    size = getattr(dt, "itemsize", None)
    if size is not None:
        return int(size)
    return _DTYPE_BYTES.get(dt, 4)


@dataclass
class CollectiveStats:
    total_bytes: int = 0
    by_op: dict[str, int] = field(default_factory=dict)
    count: int = 0

    def add(self, op: str, nbytes: int) -> None:
        self.total_bytes += nbytes
        self.by_op[op] = self.by_op.get(op, 0) + nbytes
        self.count += 1


def collective_stats(record) -> CollectiveStats:
    """Sum the result bytes of every collective in the dry run's record,
    a sequence of ``(op, result_bytes)``.

    ``op`` is a ``c10d_functional`` name (``all_gather_into_tensor``) or
    one of the reference's five (``all-gather``); anything else is not a
    collective and is skipped, as are empty results.  Result bytes are the
    per-chip traffic proxy for all collective kinds, as in the reference:
    exact for all-gather/all-reduce outputs and within 2x for
    reduce-scatter/all-to-all — adequate for a roofline *term*.
    """
    stats = CollectiveStats()
    for op, nbytes in record:
        name = op if op in _COLLECTIVES else COLLECTIVE_NAMES.get(op)
        if name is None or not nbytes:
            continue
        stats.add(name, int(nbytes))
    return stats


@dataclass
class RooflineTerms:
    """Three-term roofline for one (arch x shape x mesh) cell."""

    name: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float = 0.0
    hw: HardwareSpec = H100_SXM
    n_ops: int = 0

    # ---- the three terms, in seconds ------------------------------------
    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.hw.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.hw.ici_bw)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "hbm": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def bottleneck_class(self) -> str:
        """DAMOV-style class for the step (see module docstring).

        ``latency``: the whole step finishes in < ~100 us — per-op dispatch
        latency, not any throughput roof, governs (decode steps of small
        models land here; DAMOV Class-1b analogue)."""
        if self.t_bound < 100e-6:
            return "latency"
        return self.dominant

    # ---- hygiene ratios ---------------------------------------------------
    @property
    def useful_compute_ratio(self) -> float:
        """MODEL_FLOPS / step FLOPs (catches remat/redundancy waste)."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per HBM byte (the paper's AI analogue)."""
        return self.hlo_flops / self.hlo_bytes if self.hlo_bytes else 0.0

    @property
    def mfu_bound(self) -> float:
        """Best-case MFU implied by the roofline (useful flops / peak at
        the binding term)."""
        if self.t_bound <= 0:
            return 0.0
        return (self.model_flops or self.hlo_flops) / (
            self.t_bound * self.chips * self.hw.peak_flops
        )

    @property
    def roofline_fraction(self) -> float:
        """Compute-term share of the bound: 1.0 = perfectly compute-bound
        (at roofline); < 1 means HBM or the links dominate."""
        return self.t_compute / self.t_bound if self.t_bound > 0 else 0.0

    def summary(self) -> dict[str, object]:
        return {
            "name": self.name,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "class": self.bottleneck_class,
            "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "useful_compute_ratio": self.useful_compute_ratio,
            "arithmetic_intensity": self.arithmetic_intensity,
            "mfu_bound": self.mfu_bound,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline(
    name: str,
    *,
    chips: int,
    cost_analysis: dict[str, float] | None,
    collectives=(),
    n_ops: int = 0,
    model_flops: float = 0.0,
    hw: HardwareSpec = H100_SXM,
) -> RooflineTerms:
    """Build roofline terms from a dry run's record: ``cost_analysis``
    ``{"flops", "bytes accessed"}`` and the ``(op, result_bytes)``
    collectives (the reference takes the compiled HLO text)."""
    ca = cost_analysis or {}
    coll = collective_stats(collectives)
    return RooflineTerms(
        name=name,
        chips=chips,
        hlo_flops=float(ca.get("flops", 0.0)),
        hlo_bytes=float(ca.get("bytes accessed", 0.0)),
        collective_bytes=float(coll.total_bytes),
        model_flops=model_flops,
        hw=hw,
        n_ops=n_ops,
    )
