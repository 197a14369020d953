"""``launch.train.train_loop`` on a one-rank gloo mesh
(``make_local_mesh(device="cpu")``) on the CPU:

- on two smoke configs (the SSM and the MoE families) its losses equal the
  plain ``train_loop``'s bit for bit and its checkpoints are the same
  bytes; the LM it returns holds DTensor parameters;
- it resumes onto the mesh from the plain run's checkpoint as the plain
  run continues;
- (``test_torch_launch_mesh_train_reference.py``) the reference's
  ``train_loop`` checkpoint restores onto the port's mesh and back;
- ``SyntheticTokens.global_arrays`` on that mesh equals the reference's
  on one process.

The meshes' process groups live only inside their blocks."""

import filecmp
import os
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro.data.pipeline import SyntheticTokens as RefTokens
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import train_loop
from repro_torch.models.sharding import logical_to_spec

RUN = dict(steps=4, global_batch=4, seq_len=32, save_every=2, log_every=100)


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _on_mesh(cfg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with make_local_mesh(device="cpu") as mesh:
            lm, _, losses = train_loop(cfg, **{**RUN, **kw}, mesh=mesh)
            placed = all(isinstance(p, DTensor) for p in lm.parameters())
    return losses, placed


def _same_files(a, b) -> bool:
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)
        for n in names)


@pytest.mark.parametrize("arch", ["mamba2-780m", "deepseek-moe-16b"])
def test_mesh_loop_equals_the_plain_loop(arch, tmp_path):
    cfg = configs.get_smoke(arch)
    plain = train_loop(cfg, **RUN, ckpt_dir=str(tmp_path / "plain"),
                       device="cpu")[2]
    got, placed = _on_mesh(cfg, ckpt_dir=str(tmp_path / "mesh"))
    assert placed and len(got) == 4 and all(np.isfinite(got))
    assert got == plain
    for step in ("step_00000002", "step_00000004"):
        assert _same_files(tmp_path / "plain" / step, tmp_path / "mesh" / step)


def test_mesh_loop_resumes_from_the_plain_checkpoint(tmp_path, capsys):
    cfg = configs.get_smoke("mamba2-780m")
    plain = train_loop(cfg, **RUN, ckpt_dir=str(tmp_path / "plain"),
                       device="cpu")[2]
    shutil.copytree(tmp_path / "plain", tmp_path / "at2")
    shutil.rmtree(tmp_path / "at2" / "step_00000004")
    got, _ = _on_mesh(cfg, ckpt_dir=str(tmp_path / "at2"), resume=True)
    assert "[resume] from step 2" in capsys.readouterr().out
    assert got == plain[2:]
    assert _same_files(tmp_path / "plain" / "step_00000004",
                       tmp_path / "at2" / "step_00000004")


ARCH = "mamba2-780m"


def test_global_arrays_equal_the_references_on_one_process():
    from jax.sharding import NamedSharding, PartitionSpec

    kw = dict(vocab=512, global_batch=4, seq_len=16, extra_embed_len=3,
              d_model=8)
    ref = RefTokens(**kw)
    mesh_j = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                               ("data", "model"))
    want = ref.global_arrays(ref.batch_at(7), mesh_j,
                             PartitionSpec("data", None))
    assert isinstance(want["tokens"].sharding, NamedSharding)
    pipe = SyntheticTokens(**kw)
    with make_local_mesh(device="cpu") as mesh:
        spec = logical_to_spec(mesh, ("batch", None), (4, 16))
        got = pipe.global_arrays(pipe.batch_at(7), mesh, spec)
        assert set(got) == set(want) == {"tokens", "labels", "extra_embed"}
        for k in got:
            assert isinstance(got[k], DTensor)
            assert tuple(got[k].shape) == want[k].shape
            np.testing.assert_array_equal(got[k].full_tensor().numpy(),
                                          np.asarray(want[k]))
        # a pipeline split four ways assembles a quarter of the batch here
        with pytest.raises(ValueError, match="not the global batch"):
            SyntheticTokens(**kw, data_shards=4).global_arrays(
                SyntheticTokens(**kw, data_shards=4).batch_at(0), mesh, spec)


def test_mesh_cli_path_needs_a_launcher(monkeypatch, tmp_path):
    # without torchrun's WORLD_SIZE the CLI takes the plain path
    from repro_torch.launch.train import main

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path), "--save-every", "2"]) == 0
    assert not dist.is_initialized()
    assert os.listdir(tmp_path) == ["step_00000002"]
