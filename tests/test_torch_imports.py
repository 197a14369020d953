"""The port stands alone and has no fallback.

``repro_torch`` imports neither jax nor any module of the reference
package (nor the reference's top-level ``benchmarks`` package, which
imports it), nor ``ml_dtypes`` (which the card's machine lacks), and
imports, serves and trains with jax and ``ml_dtypes`` blocked; CUDA is never silently replaced by
the CPU: asking for it without a card raises, and a kernel wrapper given
tensors that are not on a card raises.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.capture.kernels import CAPTURED_KERNELS
from repro_torch.device import resolve_device
from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import launch_spec as flash_spec
from repro_torch.kernels.stream import ops as stream_ops
from repro_torch.kernels.stream.kernel import stream_cuda
from repro_torch.kernels.token_gather import gather
from repro_torch.suite import default_registry, registry_for
from repro_torch.benchmarks import kernel_bench, paper_figures
from repro_torch.benchmarks.run import main as bench_main
from repro_torch.study import SuiteSubstrate
from repro_torch.study.__main__ import main as study_main
from repro_torch.suite.__main__ import main as suite_main
from repro_torch import configs
from repro_torch.models import LM
from repro_torch.serve.__main__ import main as serve_main
from repro_torch.launch.train import main as train_main

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top != "jax", f"{path} imports {mod}"
        assert top != "repro", f"{path} imports {mod}"
        assert top != "benchmarks", f"{path} imports {mod}"
        assert top != "ml_dtypes", f"{path} imports {mod}"


def test_the_lm_stack_is_among_the_checked_sources():
    names = {p.relative_to(PKG).parts[0] for p in SOURCES if p.is_relative_to(PKG)}
    assert {"models", "configs", "serve"} <= names


def test_the_training_path_is_among_the_checked_sources():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if p.is_relative_to(PKG)}
    assert {"models/ssm.py", "train/step.py", "train/optimizer.py",
            "train/compress.py", "data/pipeline.py", "checkpoint/store.py",
            "launch/train.py"} <= names


def test_the_cost_substrate_and_launch_layer_are_among_the_checked_sources():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if p.is_relative_to(PKG)}
    assert {"core/analytic.py", "core/hlo_analysis.py", "launch/cells.py",
            "launch/mesh.py", "launch/specs.py", "launch/dryrun.py",
            "models/sharding.py", "benchmarks/roofline_table.py",
            "benchmarks/render_experiments.py", "quickstart.py"} <= names


def test_training_on_a_mesh_is_among_the_checked_sources():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES
             if p.is_relative_to(PKG)}
    assert {"launch/perfvariants.py", "train_lm.py", "launch/train.py",
            "data/pipeline.py", "checkpoint/store.py"} <= names


def test_mesh_training_modules_import_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ml_dtypes'] = None\n"
        "from repro_torch.launch import perfvariants, train\n"
        "from repro_torch import train_lm\n"
        "from repro_torch.data.pipeline import SyntheticTokens\n"
        "from repro_torch.checkpoint.store import local_slice\n"
        "assert len(perfvariants.VARIANTS) == 7\n"
        "assert hasattr(SyntheticTokens, 'global_arrays')\n"
        "assert 'mesh' in train.train_loop.__code__.co_varnames\n"
        "print('repro' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False"]


def test_quickstart_and_the_cost_substrate_run_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from repro_torch import quickstart\n"
        "quickstart.main()\n"
        "from repro_torch.study.__main__ import main\n"
        "assert main(['--substrate', 'hlo']) == 0\n"
        "from repro_torch.launch import dryrun, mesh, specs\n"
        "from repro_torch.benchmarks import render_experiments, roofline_table\n"
        "print('repro' in sys.modules, 'jax' in sys.modules and "
        "sys.modules['jax'] is not None)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    lines = out.stdout.splitlines()
    assert lines[-1] == "False False"
    assert any("class=collective" in line for line in lines)
    assert sum("@16x16," in line for line in lines) == 32


def test_training_path_trains_and_resumes_with_jax_blocked(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ml_dtypes'] = None\n"
        "from repro_torch.launch.train import main\n"
        f"args = ['--arch', 'mamba2-780m', '--smoke', '--steps', '2',\n"
        f"        '--batch', '2', '--seq', '16', '--device', 'cpu',\n"
        f"        '--ckpt-dir', {str(tmp_path)!r}, '--save-every', '1']\n"
        "main(args)\n"
        "main(args[:4] + ['3'] + args[5:] + ['--resume'])\n"
        "print('repro' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert "[resume] from step 2" in out.stdout
    assert out.stdout.split()[-1] == "False"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001", "step_00000002", "step_00000003"]


def test_lm_stack_imports_and_serves_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.models import LM, convert\n"
        "from repro_torch.serve import Engine, Request\n"
        "lm = LM(configs.get_smoke('deepseek-v2-lite-16b'), device='cpu')\n"
        "lm.init(torch.Generator().manual_seed(0))\n"
        "lm = convert.from_reference(convert.to_reference(lm), lm.cfg,\n"
        "                            device='cpu')\n"
        "out = Engine(lm, max_batch=2, max_len=16, prompt_buckets=(8,)).run(\n"
        "    [Request(rid=i, prompt=[1, 2, 3], max_new_tokens=3)\n"
        "     for i in range(3)])\n"
        "print(sorted(len(v) for v in out.values()), 'repro' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["[3,", "3,", "3]", "False"]


def test_package_imports_and_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.suite import SuiteRunner, default_registry\n"
        "r = SuiteRunner(default_registry(refs=2000, device='cpu'),\n"
        "                cores=(1, 4), store=None)\n"
        "rows, hist = r.roster().rows, r.histogram()\n"
        "print(len(rows), rows[21][4], ','.join(hist.columns),\n"
        "      'repro' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["45", "1a", "class,synthetic,captured,total",
                                  "False"]


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        default_registry()
    with pytest.raises(RuntimeError, match="cuda"):
        registry_for(sections=("serving",), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        suite_main(["--fast", "--no-store"])
    with pytest.raises(RuntimeError, match="cuda"):
        CAPTURED_KERNELS[0].builder(1, np.random.default_rng(0), "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        study_main(["--substrate", "suite", "--refs", "2000"])
    with pytest.raises(RuntimeError, match="cuda"):
        SuiteSubstrate(refs=2000, store=None)
    with pytest.raises(RuntimeError, match="cuda"):
        bench_main(["--fast", "--only", "fig3", "--bench-json", ""])
    with pytest.raises(RuntimeError, match="cuda"):
        paper_figures.table3_suite_roster(refs=2000)
    for rows in (kernel_bench.stream_rows, kernel_bench.attention_rows):
        with pytest.raises(RuntimeError, match="cuda"):
            rows()
    with pytest.raises(RuntimeError, match="cuda"):
        LM(configs.get_smoke("qwen2.5-14b"))
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["--arch", "mamba2-780m", "--smoke", "--steps", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_wrappers_refuse_cpu_tensors():
    a = torch.zeros(512 * 128)
    spec = stream_ops.launch_spec("copy", a.numel(), a.dtype)
    with pytest.raises(ValueError, match="CUDA"):
        stream_cuda(spec, "copy", a)
    with pytest.raises(ValueError, match="CUDA"):
        stream_cuda(spec, "copy", a, out=torch.empty_like(a))
    q = torch.zeros(1, 128, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(flash_spec(1, 128, 128, 1, 1, 64, q.dtype), q,
                             q, q, causal=True)


def test_ops_raise_on_a_device_without_a_path():
    with pytest.raises(ValueError, match="no kernel path"):
        stream_ops.stream_copy(torch.zeros(512 * 128, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        gather(torch.zeros(4, 128, device="meta"), torch.tensor([0]))


def test_entry_points_refuse_meta_and_only_the_capture_builds_there():
    """``meta`` is the abstract capture's device, reached through
    ``capture.zoo.meta_lm`` alone: every entry point's ``device=`` still
    refuses it."""
    from repro_torch.capture import zoo
    from repro_torch.suite import models_registry

    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        LM(configs.get_smoke("qwen2.5-14b"), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        models_registry(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bench_main(["--only", "models", "--device", "meta",
                    "--bench-json", ""])
    lm = zoo.meta_lm("qwen2.5-14b")
    assert lm.device.type == "meta"
    assert all(p.device.type == "meta" for p in lm.parameters())


def test_model_zoo_captures_and_classifies_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from repro_torch.capture import zoo\n"
        "from repro_torch.core import classify\n"
        "from repro_torch.benchmarks import perf_gate, timing_smoke\n"
        "(w,) = zoo.model_workloads(only=('mamba2-780m.decode.bs8.c4096',))\n"
        "m = classify.measure(w, seed=0)\n"
        "print(classify.classify(m), w.expected_class,\n"
        "      zoo.census_for(w.name)[:3], 'repro' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["1b", "1b", "(17,", "13,", "4)", "False"]


def test_build_helper_forms_the_sm90a_nvcc_line():
    cmd = _build.nvcc_command(Path("csrc/x.cu"), Path("build/libx.so"))
    assert cmd[0].endswith("nvcc")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-O3", "-shared", "-std=c++17"):
        assert flag in cmd
    assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
    assert cmd[cmd.index("-o") + 1] == "build/libx.so"
    assert cmd[-1] == "csrc/x.cu"


def test_every_kernel_has_a_source_and_a_hashed_library_path():
    assert set(KERNELS) == {"stream", "token_gather", "flash_attention",
                            "paged_kv_decode", "moe_dispatch", "ssm_ema_scan",
                            "ssm_chunked_scan", "window_scan"}
    for name in KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR
        assert lib.name.startswith(f"lib{name}-") and lib.suffix == ".so"


def test_launch_counters_reset():
    reset_launch_counts()
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.cuda
def test_smoke_lm_on_the_card_equals_the_cpu():
    """One smoke forward and prefill+decode on the card, in float32 with
    TF32 off, against the same parameters on the CPU (atol/rtol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the LM's default device is cuda")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get_smoke("deepseek-v2-lite-16b").replace(dtype="float32")
    cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = LM(cfg)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(1, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want, aux_w = cpu(tokens)
        got, aux_g = card(tokens.cuda())
        lw, cw, pw = cpu.prefill(tokens, cpu.init_cache(2, 16))
        lg, cg, pg = card.prefill(tokens.cuda(), card.init_cache(2, 16))
        dw, _ = cpu.decode_step(tokens[:, :1], cw, pw)
        dg, _ = card.decode_step(tokens[:, :1].cuda(), cg, pg)
    for a, b in ((got, want), (aux_g, aux_w), (lg, lw), (dg, dw)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                   atol=1e-4, rtol=1e-4)
