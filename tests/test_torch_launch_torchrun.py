"""``python -m repro_torch.launch.train`` under ``torchrun`` (two gloo
ranks on the CPU, ``--standalone``): the CLI reads the launcher's
``WORLD_SIZE`` and ``RANK``, trains on ``make_local_mesh()`` over the two
ranks (a 2 x 1 mesh: the batch split over "data"), and rank 0 alone
writes the checkpoint, which holds the global leaves and restores on one
process."""

import os
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.checkpoint import load_checkpoint
from repro_torch.models import LM
from repro_torch.train import AdamWConfig, init_train_state, load_train_tree

ROOT = Path(__file__).resolve().parents[1]


def test_cli_trains_on_a_mesh_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "mamba2-780m", "--smoke", "--steps", "2", "--batch", "2",
         "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
         "--save-every", "2"], env=env, cwd=tmp_path, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    step, tree = load_checkpoint(str(tmp_path))
    cfg = configs.get_smoke("mamba2-780m")
    lm = LM(cfg, device="cpu")
    state = init_train_state(lm, AdamWConfig())
    load_train_tree(lm, state, tree)
    assert step == 2 and int(state["adam"]["step"]) == 2
    assert all(torch.isfinite(p).all() for p in lm.parameters())
