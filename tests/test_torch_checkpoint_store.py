"""The port's checkpoint store (``repro_torch.checkpoint``): the
reference's crash-safety cases (an uncommitted step is invisible, a
leftover ``.tmp`` is ignored, corruption raises, retention keeps the
newest, an async save commits after ``wait`` and snapshots before the
caller changes its tensors), bf16 round-trips bit for bit without
``ml_dtypes``, each package reads the other's checkpoints with equal
leaves, and ``train_tree``, the tree a training checkpoint holds, is the
reference's parameter tree in new tensors (stacked leaves too)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import pair, port_lm
from repro.checkpoint import store as ref_store
from repro_torch.checkpoint.store import (
    CheckpointManager, latest_step, load_checkpoint, save_checkpoint)
from repro_torch.train import (AdamWConfig, init_train_state,
                               load_train_tree, train_tree)


def _tree():
    return {
        "params": {
            "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "blocks": [torch.ones((2, 2), dtype=torch.bfloat16),
                       torch.zeros((5,), dtype=torch.int32)],
        },
        "step_count": torch.tensor(7, dtype=torch.int32),
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: tree}


def _bits(x) -> tuple[str, bytes, tuple]:
    """dtype name, raw bytes and shape of a torch tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).split(".")[1]
        raw = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return name, raw.numpy().tobytes(), tuple(x.shape)
    x = np.asarray(x)
    return str(x.dtype), x.tobytes(), x.shape


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert _bits(fa[k]) == _bits(fb[k]), k


def test_round_trip_preserves_values_dtypes_structure(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree())
    step, got = load_checkpoint(str(tmp_path))
    assert step == 3
    _assert_same(got, _tree())
    assert isinstance(got["params"]["blocks"], list)
    assert os.path.isdir(tmp_path / "step_00000003")


def test_bfloat16_round_trips_bit_exact(tmp_path):
    x = {"m": torch.linspace(-3.0, 3.0, 64).to(torch.bfloat16)}
    x["m"][5] = float("nan")
    save_checkpoint(str(tmp_path), 0, x)
    raw = np.load(tmp_path / "step_00000000" / "m.npy")
    assert raw.dtype == np.uint16                 # the reference's layout
    _, got = load_checkpoint(str(tmp_path), 0)
    assert got["m"].dtype == torch.bfloat16
    assert torch.equal(got["m"].view(torch.int16), x["m"].view(torch.int16))


def test_latest_step_empty_and_missing_dir(tmp_path):
    assert latest_step(str(tmp_path)) is None
    assert latest_step(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path))


def test_uncommitted_step_is_invisible(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    save_checkpoint(d, 2, _tree())
    os.remove(os.path.join(d, "step_00000002", "COMMIT"))
    assert latest_step(d) == 1
    assert load_checkpoint(d)[0] == 1


def test_leftover_tmp_dir_is_ignored(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 4, _tree())
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert latest_step(d) == 4


def test_corrupt_leaf_and_missing_leaf_raise(tmp_path):
    d = str(tmp_path)
    final = save_checkpoint(d, 0, {"a": torch.ones(4), "b": torch.ones(4)})
    with open(os.path.join(final, "a.npy"), "wb") as f:
        f.write(b"\x00" * 10)
    with pytest.raises(ValueError):
        load_checkpoint(d, 0)
    final = save_checkpoint(d, 1, {"a": torch.ones(4), "b": torch.ones(4)})
    os.remove(os.path.join(final, "b.npy"))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(d, 1)
    mpath = os.path.join(final, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    del manifest["leaves"]["b"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(KeyError):
        load_checkpoint(d, 1)


def test_manager_retention_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((4,), float(s))})
    assert mgr.latest_step() == 4
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]


def test_manager_async_save_commits_after_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    w = torch.arange(16, dtype=torch.float32)
    mgr.save(10, {"w": w})
    w.add_(100.0)            # the caller goes on changing its tensor
    mgr.wait()
    step, got = mgr.restore_latest(device="cpu")
    assert step == 10
    assert torch.equal(got["w"], torch.arange(16, dtype=torch.float32))


def _mixed_tree():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((2, 4)).astype(np.float32)
    return f32, bf, {"params": {"layers": {"w": f32}},
                     "opt": {"mu": {"layers": {"w": bf}},
                             "step": np.int32(4)}}


def test_the_reference_reads_a_port_checkpoint(tmp_path):
    f32, bf, _ = _mixed_tree()
    tree = {"params": {"layers": {"w": torch.from_numpy(f32)}},
            "opt": {"mu": {"layers": {"w": torch.from_numpy(bf).to(
                torch.bfloat16)}}, "step": torch.tensor(4, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 4, tree)
    step, got = ref_store.load_checkpoint(str(tmp_path))
    assert step == 4
    np.testing.assert_array_equal(got["params"]["layers"]["w"], f32)
    mu = got["opt"]["mu"]["layers"]["w"]
    assert str(mu.dtype) == "bfloat16"
    assert mu.view(np.uint16).tobytes() == tree["opt"]["mu"]["layers"][
        "w"].view(torch.int16).numpy().tobytes()
    assert got["opt"]["step"].dtype == np.int32 and int(got["opt"]["step"]) == 4


def test_the_port_reads_a_reference_checkpoint(tmp_path):
    f32, bf, _ = _mixed_tree()
    tree = {"params": {"layers": {"w": jnp.asarray(f32)}},
            "opt": {"mu": {"layers": {"w": jnp.asarray(bf, jnp.bfloat16)}},
                    "step": jnp.asarray(4, jnp.int32)}}
    ref_store.save_checkpoint(str(tmp_path), 4, tree)
    step, got = load_checkpoint(str(tmp_path), device="cpu")
    assert step == 4
    assert got["params"]["layers"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(got["params"]["layers"]["w"].numpy(), f32)
    mu = got["opt"]["mu"]["layers"]["w"]
    assert mu.dtype == torch.bfloat16
    assert mu.view(torch.int16).numpy().tobytes() == np.asarray(
        tree["opt"]["mu"]["layers"]["w"]).view(np.uint16).tobytes()
    assert got["opt"]["step"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_train_tree_is_a_new_copy_in_the_references_layout(arch):
    _, params, _, _ = pair(arch, dtype="float32")
    lm = port_lm(arch)
    state = init_train_state(lm, AdamWConfig())
    tree = train_tree(lm, state)
    flat, want = jax.tree_util.tree_flatten_with_path(tree["params"])[0], \
        jax.tree_util.tree_flatten_with_path(params)[0]
    assert [k for k, _ in flat] == [k for k, _ in want]
    for (k, got), (_, w) in zip(flat, want):
        assert np.array_equal(got.numpy(), np.asarray(w)), k
    with torch.no_grad():                # the tree shares no storage
        for p in lm.parameters():
            p.add_(1.0)
    for (k, got), (_, w) in zip(flat, want):
        assert np.array_equal(got.numpy(), np.asarray(w)), k
    fresh = port_lm(arch)
    fresh_state = init_train_state(fresh, AdamWConfig())
    load_train_tree(fresh, fresh_state, tree)
    assert np.array_equal(
        fresh.embed.detach().numpy(), np.asarray(params["embed"]))
