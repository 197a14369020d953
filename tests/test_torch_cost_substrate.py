"""The port's cost substrate against the reference's: ``core.analytic``,
``core.hlo_analysis``, ``launch.cells``/``input_specs``, the ``hlo``
substrate, the driver's ``roofline`` table and ``render_experiments``.

``analytic`` is pure arithmetic and equals the reference float for float
on every cell and mesh.  The roofline terms equal the reference's on the
same inputs when the port is given a spec equal to the reference's TPU
(``TPU_V5E`` itself appears nowhere in the port); on its default, the
H100 SXM, they carry that card's published figures.
"""

import contextlib
import dataclasses
import io
import json

import jax.numpy as jnp
import pytest
import torch

from repro.core import analytic as ref_analytic
from repro.core import hlo_analysis as ref_hlo
from repro.launch import cells as ref_cells
from repro.launch import specs as ref_specs
from repro.study.substrate import HloSubstrate as RefHloSubstrate
from repro_torch import configs
from repro_torch.core import analytic, hlo_analysis
from repro_torch.core.hlo_analysis import H100_SXM, HardwareSpec
from repro_torch.launch import cells
from repro_torch.launch.specs import input_specs
from repro_torch.models.config import SHAPES
from repro_torch.study import HloSubstrate

TPU_EQUAL = HardwareSpec(**dataclasses.asdict(ref_hlo.TPU_V5E))
MESHES = {"16x16": (16, 16), "2x16x16": (32, 16)}   # (data, model) shards


def _plans():
    return [(p.arch, p.shape.name) for p in ref_cells.all_cells()]


# --------------------------------------------------------------------------
# analytic
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", _plans())
def test_cell_cost_equals_the_references(arch, shape, mesh):
    ref_plan = ref_cells.plan_for(arch, shape)
    plan = cells.plan_for(arch, shape)
    data, model = MESHES[mesh]
    kw = dict(kind=plan.kind, microbatches=plan.microbatches,
              data_shards=data, model_shards=model,
              infer_fsdp=plan.infer_fsdp)
    got = analytic.cell_cost(plan.cfg, plan.shape, **kw)
    want = ref_analytic.cell_cost(ref_plan.cfg, ref_plan.shape, **kw)
    assert (got.flops, got.hbm_bytes, got.collective_bytes) == (
        want.flops, want.hbm_bytes, want.collective_bytes)
    assert got.notes == want.notes


def test_train_flops_close_to_6nd():
    for arch in ("qwen2.5-14b", "granite-20b", "deepseek-moe-16b"):
        cfg = configs.get(arch)
        shape = SHAPES["train_4k"]
        c = analytic.cell_cost(cfg, shape, kind="train", microbatches=1,
                               data_shards=16, model_shards=16)
        model = cfg.model_flops(shape.global_batch * shape.seq_len)
        assert 0.8 < c.flops / model < 2.0, (arch, c.flops / model)


def test_decode_memory_dominated_by_kv():
    cfg = configs.get("granite-20b")
    c = analytic.cell_cost(cfg, SHAPES["decode_32k"], kind="decode",
                           microbatches=1, data_shards=16, model_shards=16)
    assert c.notes["kv_traffic"] > 0
    assert c.flops / c.hbm_bytes < 300


def test_moe_decode_expert_coverage():
    cfg = configs.get("deepseek-moe-16b")
    c_small = analytic.cell_cost(cfg, SHAPES["long_500k"], kind="decode",
                                 microbatches=1, data_shards=16,
                                 model_shards=16)
    c_big = analytic.cell_cost(cfg, SHAPES["decode_32k"], kind="decode",
                               microbatches=1, data_shards=16,
                               model_shards=16)
    assert c_small.notes["p_touch"] < 0.35 * c_small.notes["p_total"]
    assert c_big.notes["p_touch"] > 0.9 * c_big.notes["p_total"]


# --------------------------------------------------------------------------
# hlo_analysis
# --------------------------------------------------------------------------
def test_h100_sxm_carries_the_cards_published_figures():
    from repro_torch.benchmarks.kernel_bench import PEAKS

    assert H100_SXM.peak_flops == PEAKS["H100 80GB HBM3"]["bf16"] == 989e12
    assert H100_SXM.hbm_bw == PEAKS["H100 80GB HBM3"]["bytes"] == 3.35e12
    assert H100_SXM.ici_bw == 450e9
    assert H100_SXM.vmem_bytes == 50 * 2**20
    assert H100_SXM.dispatch_latency_s == ref_hlo.TPU_V5E.dispatch_latency_s
    assert hlo_analysis.RooflineTerms("x", 1, 1, 1, 0).hw is H100_SXM
    assert not hasattr(hlo_analysis, "TPU_V5E")


TERMS = [
    dict(chips=1, hlo_flops=1e15, hlo_bytes=1e9, collective_bytes=0,
         model_flops=1e15),
    dict(chips=1, hlo_flops=1e12, hlo_bytes=1e12, collective_bytes=0),
    dict(chips=256, hlo_flops=1e9, hlo_bytes=1e6, collective_bytes=0),
    dict(chips=256, hlo_flops=3e17, hlo_bytes=2e13, collective_bytes=4e14,
         model_flops=2e17),
    dict(chips=512, hlo_flops=0.0, hlo_bytes=0.0, collective_bytes=0.0),
    dict(chips=16, hlo_flops=5e13, hlo_bytes=8e11, collective_bytes=1e9,
         model_flops=1e13),
]


@pytest.mark.parametrize("kw", TERMS)
def test_roofline_terms_equal_the_references_on_a_tpu_spec(kw):
    got = hlo_analysis.RooflineTerms(name="c", hw=TPU_EQUAL, **kw)
    want = ref_hlo.RooflineTerms(name="c", **kw)
    assert got.summary() == want.summary()
    assert got.bottleneck_class == want.bottleneck_class
    assert got.t_bound == want.t_bound


def test_roofline_classes_on_the_h100():
    rt = hlo_analysis.RooflineTerms("x", 1, 1e15, 1e9, 0, model_flops=1e15)
    assert rt.bottleneck_class == "compute"
    assert rt.mfu_bound == pytest.approx(1.0)
    assert hlo_analysis.RooflineTerms("x", 1, 1e12, 1e12,
                                      0).bottleneck_class == "hbm"
    assert hlo_analysis.RooflineTerms("x", 256, 1e9, 1e6,
                                      0).bottleneck_class == "latency"
    assert hlo_analysis.RooflineTerms("x", 8, 1e12, 1e9,
                                      1e13).bottleneck_class == "collective"


def test_collective_stats_of_a_record_equal_the_hlo_parsers():
    """The reference's synthetic HLO and the same collectives as the dry
    run records them (c10d_functional op, result bytes)."""
    txt = """
  %ar = f32[1024,128]{1,0} all-reduce(f32[1024,128]{1,0} %p0)
  %rs = bf16[64,64]{1,0} reduce-scatter(bf16[512,64]{1,0} %x)
  %a2a = f32[32,32]{1,0} all-to-all(f32[32,32]{1,0} %y)
  %cp = f32[16]{0} collective-permute(f32[16]{0} %z)
  %ag = bf16[8,256]{1,0} all-gather-start(bf16[1,256]{1,0} %w)
  %agd = bf16[8,256]{1,0} all-gather-done(bf16[8,256]{1,0} %ag)
  %add = f32[999]{0} add(f32[999] %a, f32[999] %b)
"""
    record = [("all_reduce", 1024 * 128 * 4),
              ("reduce_scatter_tensor", 64 * 64 * 2),
              ("all_to_all_single", 32 * 32 * 4),
              ("send", 16 * 4),
              ("all_gather_into_tensor", 8 * 256 * 2),
              ("wait_tensor", 8 * 256 * 2),
              ("add", 999 * 4),
              ("all_reduce", 0)]
    got = hlo_analysis.collective_stats(record)
    want = ref_hlo.collective_stats(txt)
    assert (got.total_bytes, got.by_op, got.count) == (
        want.total_bytes, want.by_op, want.count)
    assert got.count == 5 and "add" not in got.by_op
    # the reference's own names pass through
    same = hlo_analysis.collective_stats(list(want.by_op.items()))
    assert same.by_op == want.by_op


def test_roofline_from_a_record():
    rt = hlo_analysis.roofline(
        "c", chips=4, cost_analysis={"flops": 4e12, "bytes accessed": 2e9},
        collectives=[("all_gather_into_tensor", 1000)], n_ops=7,
        model_flops=1e12)
    assert (rt.hlo_flops, rt.hlo_bytes, rt.collective_bytes, rt.n_ops) == (
        4e12, 2e9, 1000.0, 7)
    assert rt.hw is H100_SXM
    assert hlo_analysis.dtype_bytes("bf16") == 2
    assert hlo_analysis.dtype_bytes(torch.float32) == 4
    assert hlo_analysis.dtype_bytes("f8e4m3fn") == 1


# --------------------------------------------------------------------------
# cells and input specs
# --------------------------------------------------------------------------
def test_cells_equal_the_references():
    got, want = cells.all_cells(), ref_cells.all_cells()
    assert len(got) == len(want) == 32
    for p, r in zip(got, want):
        assert (p.arch, p.shape.name, p.kind, p.microbatches,
                p.rules_override, p.name, p.infer_fsdp) == (
            r.arch, r.shape.name, r.kind, r.microbatches, r.rules_override,
            r.name, r.infer_fsdp)
        assert dataclasses.asdict(p.cfg) == dataclasses.asdict(r.cfg)
    assert cells._MICROBATCHES == ref_cells._MICROBATCHES
    assert cells.plan_for("nemotron-4-340b", "decode_32k").infer_fsdp
    assert not cells.plan_for("nemotron-4-340b", "train_4k").infer_fsdp


@pytest.mark.parametrize("arch,shape", _plans())
def test_input_specs_equal_the_references(arch, shape):
    got = input_specs(cells.plan_for(arch, shape))
    want = ref_specs.input_specs(ref_cells.plan_for(arch, shape), None)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.shape == tuple(want[k].shape), k
        assert v.dtype == getattr(torch, jnp.dtype(want[k].dtype).name), k


# --------------------------------------------------------------------------
# the hlo substrate, the roofline table, render_experiments
# --------------------------------------------------------------------------
def test_hlo_substrate_rows_equal_the_references_on_a_tpu_spec():
    got = HloSubstrate(hw=TPU_EQUAL)
    want = RefHloSubstrate()
    assert got.items() == want.items()
    g, w = got.characterize(), want.characterize()
    assert g.columns == w.columns and g.name == w.name
    assert g.to_rows() == w.to_rows()
    assert HloSubstrate().characterize().to_rows() != w.to_rows()


def _entries(tmp_path):
    """A directory of reference-format dry-run entries: two ok cells with
    made-up terms, an error entry and the skips file."""
    d = tmp_path / "dry"
    d.mkdir()
    ok = {"arch": "qwen2.5-14b", "shape": "decode_32k", "mesh": "2x16x16",
          "status": "ok", "compile_s": 12.5, "t_compute_s": 1.25e-4,
          "t_memory_s": 3.5e-3, "t_collective_s": 2.0e-5, "dominant": "hbm",
          "class": "hbm", "mfu_bound": 0.0123, "useful_compute_ratio": 0.98,
          "roofline_fraction": 0.0357,
          "memory": {"argument_size_in_bytes": 9_120_753_696,
                     "temp_size_in_bytes": 64_495_872}}
    (d / "qwen2.5-14b__decode_32k__2pod.json").write_text(json.dumps(ok))
    ok2 = dict(ok, arch="mamba2-780m", shape="prefill_32k", mesh="16x16",
               compile_s=95.0, t_compute_s=2.0e-2, dominant="compute",
               **{"class": "compute"})
    (d / "mamba2-780m__prefill_32k__1pod.json").write_text(json.dumps(ok2))
    err = {"arch": "granite-20b", "shape": "train_4k", "mesh": "16x16",
           "status": "error", "error": "RuntimeError: " + "x" * 100}
    (d / "granite-20b__train_4k__1pod.json").write_text(json.dumps(err))
    (d / "_skips.json").write_text("[]")
    return d


@pytest.mark.parametrize("with_entries", [False, True])
def test_roofline_rows_equal_the_references(with_entries, tmp_path,
                                            monkeypatch):
    import benchmarks.roofline_table as ref_table
    from repro_torch.benchmarks import roofline_table

    d = _entries(tmp_path) if with_entries else tmp_path / "none"
    monkeypatch.setattr(ref_table, "RESULTS_DIR", str(d))
    got, header = roofline_table.rows(results_dir=str(d), hw=TPU_EQUAL)
    want, ref_header = ref_table.rows()
    assert header == ref_header and got == want
    assert len(got) == 64 + 8
    monkeypatch.setattr(roofline_table, "RESULTS_DIR", str(d))
    h100, _ = roofline_table.rows()
    assert [r[:3] for r in h100] == [r[:3] for r in want]


def test_render_experiments_prints_the_references_markdown(tmp_path):
    import benchmarks.render_experiments as ref_render
    from repro_torch.benchmarks import render_experiments

    d = _entries(tmp_path)
    outs = []
    for mod in (render_experiments, ref_render):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(str(d))
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") == 2 + 3 and "ERROR" in outs[0]


def test_quickstart_runs_its_walkthrough_and_the_h100_analogue(capsys):
    from repro_torch import quickstart

    quickstart.main()
    out = capsys.readouterr().out
    assert "-> bottleneck class 1a" in out
    assert "Card analogue" in out and "h100_sxm" in out
    assert "class=collective" in out
