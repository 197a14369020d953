"""The port stands alone and has no fallback.

``repro_torch`` imports neither jax nor any module of the reference
package, and imports with jax blocked; CUDA is never silently replaced by
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
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ops import launch_spec as flash_spec
from repro_torch.kernels.stream import ops as stream_ops
from repro_torch.kernels.stream.kernel import stream_cuda
from repro_torch.kernels.token_gather import gather
from repro_torch.suite import default_registry, registry_for
from repro_torch.suite.__main__ import main as suite_main

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
        flash_attention(flash_spec(1, 128, 128, 1, 1, 64, q.dtype), q, q, q,
                        causal=True)


def test_ops_raise_on_a_device_without_a_path():
    with pytest.raises(ValueError, match="no kernel path"):
        stream_ops.stream_copy(torch.zeros(512 * 128, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        gather(torch.zeros(4, 128, device="meta"), torch.tensor([0]))


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
