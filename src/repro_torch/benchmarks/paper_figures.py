"""Benchmarks reproducing every DAMOV table/figure as queries over one
shared :class:`repro_torch.study.Study` (counterpart of the reference's
``benchmarks/paper_figures.py``).

Each figure function takes a Study and returns a columnar
:class:`repro.study.StudyResult`.  All figures read from the study's
memoized engine, so the whole set runs one simulation pass: a cell
simulated for Fig. 1 is recalled — not re-simulated — by Figs. 4, 5, 7 and
the case studies.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import casestudies, classify, tracegen
from repro_torch.study import Study, StudyResult


def default_study(refs: int | None = None, *, backend: str | None = None) -> Study:
    """The standard synthetic-suite study all sections share.

    ``refs`` defaults to :data:`repro_torch.core.tracegen.DEFAULT_REFS`;
    ``backend`` picks the cache-simulation implementation.
    """
    return Study(refs=refs, backend=backend)


def _as_study(study) -> Study:
    if study is None:
        return default_study()
    if isinstance(study, Study):
        return study
    return Study(suite=study)  # a bare workload list


# --------------------------------------------------------------------------
# Figure 1: roofline scatter + MPKI vs NDP speedup
# --------------------------------------------------------------------------
def fig1_roofline_mpki(study=None) -> StudyResult:
    study = _as_study(study)
    res = StudyResult("fig1", ("name", "class", "ai", "mpki",
                               "ndp_speedup_mean", "min", "max",
                               "fig1_category"))
    for w in study:
        m = study.metrics(w)
        r = study.scalability(w)
        sp = r.speedup_ndp_vs_host()
        # roofline coordinates: AI (flops/byte) vs attained perf fraction
        ai_flops_per_byte = w.ai_ops_per_access / 64.0 * 8
        cat = ("faster_on_ndp" if min(sp) > 1.05 else
               "faster_on_cpu" if max(sp) < 0.95 else
               "similar" if max(sp) < 1.05 and min(sp) > 0.95 else
               "depends")
        res.append((w.name, w.expected_class, round(ai_flops_per_byte, 3),
                    round(m.mpki, 2), round(float(np.mean(sp)), 3),
                    round(min(sp), 3), round(max(sp), 3), cat))
    return res


# --------------------------------------------------------------------------
# Figure 3: locality-based clustering (Step 2)
# --------------------------------------------------------------------------
def fig3_locality_clustering(study=None) -> StudyResult:
    study = _as_study(study)
    pts = [(w.name, w.expected_class) + study.locality(w) for w in study]
    # k-means, k=2 on temporal locality (the paper's emergent split)
    temps = np.array([p[3] for p in pts])
    c0, c1 = temps.min(), temps.max()
    for _ in range(20):
        assign = np.abs(temps - c0) <= np.abs(temps - c1)
        if assign.any() and (~assign).any():
            c0, c1 = temps[assign].mean(), temps[~assign].mean()
    res = StudyResult("fig3", ("name", "class", "spatial", "temporal",
                               "kmeans_cluster"))
    for (n, c, s, t), a in zip(pts, assign):
        res.append((n, c, round(s, 3), round(t, 3),
                    "low_temporal" if a else "high_temporal"))
    return res


# --------------------------------------------------------------------------
# Figure 4: LFMR + MPKI per function
# --------------------------------------------------------------------------
def fig4_lfmr_mpki(study=None) -> StudyResult:
    study = _as_study(study)
    res = StudyResult("fig4", ("name", "class", "mpki") + tuple(
        f"lfmr@{c}" for c in study.cores))
    for w in study:
        m = study.metrics(w)
        res.append((w.name, w.expected_class, round(m.mpki, 2))
                   + tuple(round(x, 3) for x in m.lfmr_by_cores))
    return res


# --------------------------------------------------------------------------
# Figure 5 (+16): performance scalability curves, 3 systems
# --------------------------------------------------------------------------
def fig5_scalability(study=None, *, nuca=False) -> StudyResult:
    study = _as_study(study)
    res = StudyResult("fig5_nuca" if nuca else "fig5",
                      ("name", "class", "system") + tuple(
                          f"perf@{c}" for c in study.cores))
    for w in study:
        r = study.scalability(w, nuca=nuca)
        for cfg in ("host", "host+pf", "ndp"):
            res.append((w.name, w.expected_class, cfg) + tuple(
                round(p, 2) for p in r.perf_normalized(cfg)))
    return res


# --------------------------------------------------------------------------
# Figures 7/9/10/12/14/15 (+17): energy breakdowns
# --------------------------------------------------------------------------
def fig7_energy(study=None, *, nuca=False) -> StudyResult:
    study = _as_study(study)
    res = study.energy_table(nuca=nuca)
    res.name = "fig7"
    return res


# --------------------------------------------------------------------------
# Table 3: the registered benchmark-suite roster (classification section).
# Synthetic family expansions and traces walked from the port's CUDA kernel
# launches appear in one table, classified by one methodology
# (repro_torch.suite).
# --------------------------------------------------------------------------
def table3_suite_roster(runner=None, *, refs: int | None = None,
                        store=None, backend: str | None = None,
                        device: str = "cuda") -> StudyResult:
    """One row per suite entry: domain, source, metrics, assigned vs
    expected class.  ``runner``: a :class:`repro_torch.suite.SuiteRunner`
    to reuse (engine + result store); otherwise a runner over the default
    registry at ``refs`` is built, its captured entries launching on
    ``device`` (``"cuda"`` raises without a card), persisting to ``store``
    (a :class:`repro_torch.suite.ResultStore`; None disables persistence)
    and simulating on ``backend``."""
    if runner is None:
        from repro_torch.suite import SuiteRunner, default_registry
        runner = SuiteRunner(default_registry(refs=refs, device=device),
                             store=store, backend=backend)
    res = runner.roster()
    res.name = "table3"
    return res


# --------------------------------------------------------------------------
# Figure 18 + §3.5: per-class summary and held-out validation accuracy
# --------------------------------------------------------------------------
def fig18_summary_and_validation(study=None) -> StudyResult:
    study = _as_study(study)
    thresholds = classify.derive_thresholds(study.metrics_all())

    # held-out traces at the same length as the training study's, so
    # thresholds and validation metrics are measured consistently
    held = tracegen.make_suite(refs=study.refs or tracegen.DEFAULT_REFS,
                               variants=5, seed=123)[len(study):]
    held_study = Study(suite=held, backend=study.engine.backend)
    acc, _ = classify.validate(held_study.metrics_all(), thresholds)

    res = StudyResult("fig18", ("core_model", "class", "ndp_speedup_mean",
                                "min", "max"))
    for core_model in ("ooo", "inorder"):
        by_class: dict[str, list[float]] = {}
        for w in study:
            r = study.scalability(w, core_model=core_model)
            by_class.setdefault(w.expected_class, []).extend(
                r.speedup_ndp_vs_host())
        for cls in sorted(by_class):
            v = np.array(by_class[cls])
            res.append((core_model, cls, round(float(v.mean()), 3),
                        round(float(v.min()), 3), round(float(v.max()), 3)))
    res.append(("validation_accuracy", f"{acc:.3f}",
                f"thresholds: T={thresholds.temporal:.2f} "
                f"LFMR={thresholds.lfmr:.2f} MPKI={thresholds.mpki:.1f} "
                f"AI={thresholds.ai:.1f}", "", ""))
    return res


# --------------------------------------------------------------------------
# §5 case studies (shared engine: the 4-core cells are already simulated)
# --------------------------------------------------------------------------
def case1_noc(study=None) -> StudyResult:
    study = _as_study(study)
    res = StudyResult("case1", ("name", "mean_hops", "local_fraction",
                                "noc_overhead_pct"))
    for w in study.suite[:8]:
        r = casestudies.noc_study(w, engine=study.engine)
        res.append((w.name, round(r.mean_hops, 2),
                    round(r.local_fraction, 3), round(r.overhead_pct, 1)))
    return res


def case2_accelerators(study=None) -> StudyResult:
    study = _as_study(study)
    res = StudyResult("case2", ("name", "class",
                                "ndp_accel_speedup_vs_cc_accel"))
    for name in ("STRCpy", "LIGPrkEmd", "CHAHsti", "PLYalu", "HPGSpm",
                 "RODNw"):
        w = study.workload(name)
        res.append((name, w.expected_class,
                    round(casestudies.accelerator_study(
                        w, engine=study.engine), 3)))
    return res


def case3_core_models(study=None) -> StudyResult:
    study = _as_study(study)
    res = StudyResult("case3", ("name", "ndp_128_inorder_speedup",
                                "ndp_6_ooo_speedup"))
    for name in ("STRCpy", "LIGPrkEmd", "CHAHsti", "PLYalu", "PLYgemver",
                 "SPLLucb"):
        r = casestudies.core_model_study(study.workload(name),
                                         engine=study.engine)
        res.append((name, round(r["ndp_inorder_128"], 2),
                    round(r["ndp_ooo_6"], 2)))
    return res


def case4_offload(study=None) -> StudyResult:
    study = _as_study(study)
    res = StudyResult("case4", ("name", "hottest_bb_miss_share",
                                "speedup_bb", "speedup_full"))
    for name in ("LIGPrkEmd", "HSJNPO", "DRKRes"):
        r = casestudies.finegrained_offload_study(study.workload(name),
                                                  engine=study.engine)
        res.append((name, round(r["hottest_block_miss_share"], 3),
                    round(r["speedup_hottest_block"], 3),
                    round(r["speedup_full_function"], 3)))
    return res
