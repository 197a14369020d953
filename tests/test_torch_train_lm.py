"""``python -m repro_torch.train_lm``, the port's counterpart of the
reference's ``examples/train_lm.py``, on the CPU with jax blocked: its
``--kill-and-resume`` run trains half the steps, resumes from the
checkpoint the first half left under the system temp dir, and its
loss-decreases assertion holds."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_kill_and_resume_trains_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ml_dtypes'] = None\n"
        "from repro_torch.train_lm import main\n"
        "assert main(['--kill-and-resume', '--steps', '24', '--device', "
        "'cpu']) == 0\n"
        "print('repro' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "[resume] from step 12" in lines
    assert "training signal confirmed (loss decreased)." in lines
    assert lines[-1] == "False"
    ckpt = tmp_path / "repro_torch_example_ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "step_00000012", "step_00000024"]


def test_default_device_needs_a_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.train_lm",
                          "--steps", "2"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "cuda" in out.stderr
