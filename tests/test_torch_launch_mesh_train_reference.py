"""The reference's ``train_loop`` checkpoint restores onto the port's
one-rank gloo mesh (``launch.train.train_loop(mesh=...)``) and continues
as the reference does, and the reverse: five smoke steps of mamba2 in
float32 from the reference's initial parameters give the reference's
losses, and each loop resumes from the other's step-3 checkpoint (rtol
1e-5, as ``test_torch_launch_train.py`` holds the two packages' plain
loops)."""

import shutil
import warnings

import numpy as np
import pytest
import torch.distributed as dist

from _torch_lm import port_lm
from repro import configs as ref_configs
from repro.launch.train import train_loop as ref_train_loop
from repro.train import AdamWConfig as RefAdamW
from repro_torch.checkpoint import save_checkpoint
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import train_loop
from repro_torch.train import AdamWConfig, init_train_state, train_tree

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


ARCH = "mamba2-780m"
XRUN = dict(steps=5, global_batch=4, seq_len=32, save_every=3, log_every=100)


def _ref(ckpt_dir, resume=False):
    cfg = ref_configs.get_smoke(ARCH).replace(dtype="float32")
    return ref_train_loop(cfg, **XRUN, ckpt_dir=str(ckpt_dir), resume=resume,
                          opt=RefAdamW(total_steps=5, warmup_steps=0))[2]


def _port_mesh(ckpt_dir, resume=False):
    """The port's losses on the mesh; unless ``resume``, from the
    reference's initial parameters, written as step 0 first."""
    opt = AdamWConfig(total_steps=5, warmup_steps=0)
    lm = port_lm(ARCH)
    if not resume:
        save_checkpoint(str(ckpt_dir), 0,
                        train_tree(lm, init_train_state(lm, opt)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with make_local_mesh(device="cpu") as mesh:
            return train_loop(lm.cfg, **XRUN, opt=opt, ckpt_dir=str(ckpt_dir),
                              resume=True, mesh=mesh)[2]


def _at_step_3(src, dst):
    shutil.copytree(src, dst)
    shutil.rmtree(dst / "step_00000005")
    return dst


def test_reference_checkpoints_restore_onto_the_mesh_and_back(tmp_path):
    ref_losses = _ref(tmp_path / "ref")
    port_losses = _port_mesh(tmp_path / "port")
    np.testing.assert_allclose(port_losses, ref_losses, rtol=LOSS_RTOL)
    resumed = _port_mesh(_at_step_3(tmp_path / "ref", tmp_path / "r3"), True)
    np.testing.assert_allclose(resumed, ref_losses[3:], rtol=LOSS_RTOL)
    resumed = _ref(_at_step_3(tmp_path / "port", tmp_path / "p3"), True)
    np.testing.assert_allclose(resumed, port_losses[3:], rtol=LOSS_RTOL)
