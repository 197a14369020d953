"""``repro_torch.launch.perfvariants`` against the reference's
``repro.launch.perfvariants``:

- the seven variants of the reference's ``main()`` (tags, cells and
  knobs) are the port's ``VARIANTS``;
- each variant's analytic fields (the three-term roofline with the
  EP-only TP and FSDP adjustments and the int8 payload) equal the
  reference's ``run_variant``'s float for float on a spec equal to the
  reference's TPU.  The reference runs in a child process with its compile
  side stubbed (the production mesh, ``build_cell``, ``jax.jit``,
  ``jax.eval_shape``, ``tree_shardings``): importing it sets
  ``XLA_FLAGS``, which must not reach a pytest worker, and its analytic
  terms do not read what the stubs return;
- an EP-only and an int8 error-feedback variant, on a smoke config, are
  ``ok`` end to end on a fake 2x2 mesh and on the fake 16x16 production
  mesh through ``run_variant``, which writes its JSON entry.
"""

import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

from repro.core import hlo_analysis as ref_hlo
from repro_torch import configs
from repro_torch.core.hlo_analysis import HardwareSpec
from repro_torch.launch import perfvariants as PV
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models.config import ShapeSpec

ROOT = Path(__file__).resolve().parents[1]
TPU_EQUAL = HardwareSpec(**dataclasses.asdict(ref_hlo.TPU_V5E))

_CHILD = r'''
import json, os, sys, types
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import repro.launch.perfvariants as pv
import repro.models.sharding as shardlib


class Mesh:
    def __init__(self, multi_pod=False):
        self.devices = types.SimpleNamespace(size=512 if multi_pod else 256)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Compiled:
    def as_text(self):
        return ""

    def memory_analysis(self):
        return types.SimpleNamespace(temp_size_in_bytes=0,
                                     argument_size_in_bytes=0)


class Jitted:
    def lower(self, *args):
        return types.SimpleNamespace(compile=Compiled)


pv.make_production_mesh = lambda multi_pod=False: Mesh(multi_pod)
pv.build_cell = lambda plan, mesh: (None, (None, None, None),
                                    (None, None, None), None, {})
pv.jax = types.SimpleNamespace(jit=lambda fn, **kw: Jitted(),
                               eval_shape=lambda fn, *a: None)
shardlib.tree_shardings = lambda *a, **kw: None
run = pv.run_variant
got = {}


def recording(tag, arch, shape, **kw):
    entry = run(tag, arch, shape, out_dir=sys.argv[1], **kw)
    got[tag] = {"call": [arch, shape, kw], "entry": entry}
    return entry


pv.run_variant = recording
pv.main()
print(json.dumps(got, default=list))
'''


def _listed(x):
    if isinstance(x, (tuple, list)):
        return [_listed(v) for v in x]
    if isinstance(x, dict):
        return {k: _listed(v) for k, v in x.items()}
    return x


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("perf")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _CHILD, str(out)], env=env,
                         cwd=out, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


def test_the_seven_variants_are_the_references(reference):
    assert list(reference) == list(PV.VARIANTS)
    for tag, (arch, shape, kw) in PV.VARIANTS.items():
        assert reference[tag]["call"] == [arch, shape, _listed(kw)], tag
    assert list(PV.EP_ONLY) == [tuple(x) for x in
                                reference["ds_train_ep_only"]["call"][2]
                                ["rules_override"]]


@pytest.mark.parametrize("tag", list(PV.VARIANTS))
def test_analytic_fields_equal_the_references(reference, tag):
    arch, shape, kw = PV.VARIANTS[tag]
    plan = PV.variant_plan(arch, shape,
                           rules_override=kw.get("rules_override", ()),
                           microbatches=kw.get("microbatches"))
    got = PV.analytic_terms(tag, plan, 256, compress=kw.get("compress"),
                            tp_layers=kw.get("tp_layers", True), hw=TPU_EQUAL)
    want = reference[tag]["entry"]
    assert set(got) <= set(want)
    for key, value in got.items():
        assert value == want[key], (key, value, want[key])
    assert want["microbatches"] == plan.microbatches


@pytest.mark.parametrize("tag", ["ds_train_ep_only", "ds_train_ep_int8"])
def test_mini_variant_records_on_a_fake_2x2_mesh(tag):
    arch, shape, kw = PV.VARIANTS[tag]
    plan = dataclasses.replace(
        PV.variant_plan(arch, shape, rules_override=kw["rules_override"]),
        cfg=configs.get_smoke(arch), shape=ShapeSpec("t", 64, 4, "train"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with fake_mesh((2, 2), ("data", "model")) as mesh:
            got = PV.record_step(plan, mesh, compress=kw.get("compress"))
    assert got["hlo_collective_bytes_per_iter"] > 0
    assert got["memory"]["argument_size_in_bytes"] > 0
    assert got["memory"]["temp_size_in_bytes"] > 0
    # the int8 cell carries its f32 error buffers beside the moments
    if kw.get("compress"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with fake_mesh((2, 2), ("data", "model")) as mesh:
                base = PV.record_step(plan, mesh)
        assert got["memory"]["argument_size_in_bytes"] > \
            base["memory"]["argument_size_in_bytes"]


def test_run_variant_writes_an_ok_entry(monkeypatch, tmp_path):
    base = PV.plan_for
    monkeypatch.setattr(PV, "plan_for", lambda arch, shape: dataclasses.replace(
        base(arch, shape), cfg=configs.get_smoke(arch),
        shape=ShapeSpec("t", 64, 32, "train")))   # 32 rows: 16 data shards
    arch, shape, kw = PV.VARIANTS["ds_train_ep_int8"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        entry = PV.run_variant("ds_train_ep_int8", arch, shape,
                               out_dir=str(tmp_path), **kw)
    assert entry["status"] == "ok" and entry["chips"] == 256
    assert entry["compress"] == "int8_ef"
    assert entry["rules_override"] == [list(x) for x in PV.EP_ONLY]
    on_disk = json.loads((tmp_path / "ds_train_ep_int8.json").read_text())
    assert on_disk == json.loads(json.dumps(entry))
    for key in ("class", "t_compute_s", "t_memory_s", "t_collective_s",
                "temp_gb", "arg_gb", "hlo_collective_by_op"):
        assert key in entry


def test_cli_refuses_an_unknown_variant():
    with pytest.raises(SystemExit):
        PV.main(["--only", "no_such_variant"])
