"""The port's training driver (``repro_torch.launch.train``) on the CPU
against ``repro.launch.train.train_loop``: five smoke steps of mamba2's
smoke config in float32 give the reference's losses (rtol 1e-5: the
losses agree to about 1e-7, and the bf16 moments and gradients could
round a last-bit difference the other way), each loop resumes from the
other's checkpoint at step 3 and continues as the writer did, and a
resumed port run repeats the uninterrupted one exactly.  The port's loop
starts from the reference's initial parameters by resuming from a step-0
checkpoint that holds them."""

import shutil

import numpy as np
import pytest
import torch

from _torch_lm import port_lm
from repro import configs as ref_configs
from repro.launch.train import train_loop as ref_train_loop
from repro.train import AdamWConfig as RefAdamW
from repro_torch.checkpoint import save_checkpoint
from repro_torch.launch.train import main, train_loop
from repro_torch.train import AdamWConfig, init_train_state, train_tree

ARCH = "mamba2-780m"
RUN = dict(steps=5, global_batch=4, seq_len=32, save_every=3, log_every=100)
LOSS_RTOL = 1e-5


def _port(ckpt_dir, resume=False, steps=5):
    """The port's losses; unless ``resume``, from the reference's initial
    parameters, written to ``ckpt_dir`` as step 0 first."""
    opt = AdamWConfig(total_steps=5, warmup_steps=0)
    lm = port_lm(ARCH)
    if not resume:
        save_checkpoint(str(ckpt_dir), 0,
                        train_tree(lm, init_train_state(lm, opt)))
    return train_loop(lm.cfg, **{**RUN, "steps": steps}, opt=opt,
                      ckpt_dir=str(ckpt_dir), resume=True, device="cpu")[2]


def _ref(ckpt_dir=None, resume=False):
    cfg = ref_configs.get_smoke(ARCH).replace(dtype="float32")
    return ref_train_loop(cfg, **RUN, ckpt_dir=ckpt_dir, resume=resume,
                          opt=RefAdamW(total_steps=5, warmup_steps=0))[2]


def _at_step_3(src, dst):
    """A copy of a checkpoint directory holding only step 3."""
    shutil.copytree(src, dst)
    shutil.rmtree(dst / "step_00000005")
    return str(dst)


def test_losses_and_checkpoints_cross_between_the_packages(tmp_path):
    ref_losses = _ref(ckpt_dir=str(tmp_path / "ref"))
    port_losses = _port(ckpt_dir=tmp_path / "port")
    assert len(port_losses) == 5 and all(np.isfinite(port_losses))
    np.testing.assert_allclose(port_losses, ref_losses, rtol=LOSS_RTOL)
    # the port resumes from the reference's step 3, and the reverse
    resumed = _port(_at_step_3(tmp_path / "ref", tmp_path / "r3"), True)
    np.testing.assert_allclose(resumed, ref_losses[3:], rtol=LOSS_RTOL)
    resumed = _ref(_at_step_3(tmp_path / "port", tmp_path / "p3"), True)
    np.testing.assert_allclose(resumed, port_losses[3:], rtol=LOSS_RTOL)


def test_resume_repeats_the_uninterrupted_run(tmp_path, capsys):
    whole = _port(tmp_path / "whole")
    first = _port(ckpt_dir=tmp_path / "run", steps=3)
    assert first == whole[:3]
    rest = _port(ckpt_dir=tmp_path / "run", resume=True)
    assert "[resume] from step 3" in capsys.readouterr().out
    assert rest == whole[3:]


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    assert main(["--arch", ARCH, "--smoke", "--steps", "10", "--batch", "2",
                 "--seq", "16", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path), "--save-every", "5"]) == 0
    out = capsys.readouterr().out
    assert "step    10 loss" in out and "ms/step" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000005", "step_00000010"]


def test_cli_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", ARCH, "--smoke", "--steps", "1"])
