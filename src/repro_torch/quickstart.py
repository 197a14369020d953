"""Quickstart: the DAMOV methodology end-to-end on a new 'application'
(the port's counterpart of the reference's ``examples/quickstart.py``).

Characterizes a workload the classifier has never seen (a blocked
matrix-transpose access pattern) through the unified ``repro_torch.study``
API: one :class:`~repro_torch.study.Study` holds the workload, its
memoized engine runs each simulation cell once, and metrics /
classification / scalability are cached queries over it.  Then shows the
card-side analogue: the same Step-3 question answered by the ``hlo``
substrate's terms for an LM training step on a 16 x 16 mesh of H100 SXM
cards.  Needs no card.

Run:  PYTHONPATH=src python -m repro_torch.quickstart
"""

import numpy as np

from repro_torch import configs
from repro_torch.core import analytic, hlo_analysis, tracegen
from repro_torch.models.config import SHAPES
from repro_torch.study import Study


def make_transpose_workload(n: int = 1024) -> tracegen.Workload:
    """Naive out-of-place transpose of an n x n f64 matrix: rows stream,
    columns stride — the DAMOV 1a-style pattern every textbook uses."""

    def gen(cores, rng):
        rows = np.arange(n * n // cores, dtype=np.int64)           # A[i][j]
        cols = (rows % n) * n + rows // n                          # B[j][i]
        addr = np.empty(2 * rows.size, dtype=np.int64)
        addr[0::2] = rows
        addr[1::2] = 2 ** 27 + cols
        return tracegen.TraceSpec(addr[:120_000], l3_factor=1.0 / cores,
                                  mlp=6.0, dram_rows_irregular=False)

    return tracegen.Workload(
        name="Transpose", family="stream", expected_class="1a",
        ai_ops_per_access=0.5, instr_per_access=2.5, gen=gen)


def main():
    print("=== DAMOV Steps 1-3 on a new workload (repro_torch.study API) ===")
    w = make_transpose_workload()
    study = Study(suite=[w])

    spatial, temporal = study.locality(w)
    m = study.metrics(w)
    cls = study.classify(w)
    print(f"workload={w.name}")
    print(f"  Step 2 (arch-independent): temporal={temporal:.2f} "
          f"spatial={spatial:.2f}")
    print(f"  Step 3 (arch-dependent):   AI={m.ai:.1f} MPKI={m.mpki:.1f} "
          f"LFMR={[round(x, 2) for x in m.lfmr_by_cores]}")
    print(f"  -> bottleneck class {cls} "
          f"({'DRAM bandwidth-bound' if cls == '1a' else cls})")

    r = study.scalability(w)
    sp = r.speedup_ndp_vs_host()
    print(f"  NDP speedup across 1..256 cores: "
          f"{[round(s, 2) for s in sp]}")
    verdict = "NDP-friendly" if np.mean(sp) > 1.1 else "cache-friendly"
    print(f"  verdict: {verdict}")
    s = study.stats
    print(f"  engine: {study.engine.cells} cells simulated once, "
          f"{s.sim_hits} recalled from cache\n")

    hw = hlo_analysis.H100_SXM
    print(f"=== Card analogue: classify an LM training step ({hw.name}) ===")
    cfg = configs.get("deepseek-moe-16b")
    shape = SHAPES["train_4k"]
    cost = analytic.cell_cost(cfg, shape, kind="train", microbatches=2,
                              data_shards=16, model_shards=16)
    rt = hlo_analysis.RooflineTerms(
        name="deepseek-moe train_4k", chips=256,
        hlo_flops=cost.flops, hlo_bytes=cost.hbm_bytes,
        collective_bytes=cost.collective_bytes,
        model_flops=cfg.model_flops(shape.global_batch * shape.seq_len),
        hw=hw)
    s = rt.summary()
    print(f"  t_compute={s['t_compute_s']:.3e}s  "
          f"t_memory={s['t_memory_s']:.3e}s  "
          f"t_collective={s['t_collective_s']:.3e}s")
    print(f"  -> class={s['class']}  mfu_bound={s['mfu_bound']:.3f}")
    print("  (the hlo substrate: python -m repro_torch.study --substrate hlo)")


if __name__ == "__main__":
    main()
