"""``launch.train.train_loop`` over four ranks (gloo, a 2x2 ("data",
"model") mesh, one process a rank) on the CPU, in float64 compute with
float32 gradients and moments, as ``test_torch_launch_multirank.py`` runs
its train cells:

- fed the same assembled global batch as a plain train step
  (``SyntheticTokens.global_arrays``: each data shard's ranks hold the
  same slice, and every rank draws from the same Philox counter, so the
  global batch is one slice twice), its losses lie within 1e-6 of the
  plain step's (a few float32 ulps: the master weights and the moments
  are float32, summed in another order), and its gathered state after
  three steps, leaf by leaf (parameters, both moments, the step), within
  1e-5 of the leaf's rms plus 16 float32 ulps of itself, the limit
  ``test_torch_launch_multirank.py`` holds its train cells to;
- the 2x2 split assembles ``global_batch`` rows, and the reference's split
  by the process count (four slices of a quarter) is refused;
- a checkpoint written by the four ranks (rank 0 alone writes) restores
  on one process leaf for leaf equal to the ranks' gathered state, and a
  one-process checkpoint restores onto the four ranks equal leaf for
  leaf;
- the int8 error-feedback round trip on DTensor gradients gives each
  leaf the scale of the plain path: dequantized gradients and error
  buffers equal the plain ones bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r'''
import json, os, sys, tempfile, warnings
warnings.simplefilter("ignore")
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCH = "mamba2-780m"
RUN = dict(global_batch=4, seq_len=16, log_every=100)


def rank_main(rank, store, work, out):
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch import configs
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import place_parameters, rules_for
    from repro_torch.models import LM
    from repro_torch.models.sharding import logical_to_spec
    from repro_torch.train import (AdamWConfig, compress, init_train_state,
                                   load_train_tree, train_tree)
    from repro_torch.train import build_train_step as step_of

    def build_train_step(*a, **kw):
        return step_of(*a, grad_dtype="float32", **kw)

    T.build_train_step = build_train_step
    cfg = configs.get_smoke(ARCH).replace(dtype="float64")
    opt = AdamWConfig(state_dtype="float32", total_steps=3, warmup_steps=0)
    res = {}
    dist.init_process_group("gloo", rank=rank, world_size=4,
                            init_method=f"file://{store}")
    with make_local_mesh(model_axis=2, device="cpu") as mesh:
        spec = logical_to_spec(mesh, ("batch", None), (4, 16))
        pipe = SyntheticTokens(vocab=cfg.vocab, global_batch=4, seq_len=16,
                               data_shards=2)
        g = pipe.global_arrays(pipe.batch_at(0), mesh, spec)["tokens"]
        res["rows"] = list(g.shape)
        quarter = SyntheticTokens(vocab=cfg.vocab, global_batch=4,
                                  seq_len=16)     # split by the 4 ranks
        try:
            quarter.global_arrays(quarter.batch_at(0), mesh, spec)
            res["quarter_refused"] = False
        except ValueError:
            res["quarter_refused"] = True
        # three steps on the mesh, a checkpoint at step 3 (rank 0 writes)
        lm, st, losses = T.train_loop(cfg, steps=3, save_every=3, opt=opt,
                                      ckpt_dir=os.path.join(work, "mesh"),
                                      mesh=mesh, **RUN)
        state = train_tree(lm, st)        # gathered on every rank
        if rank == 0:
            res["losses"] = losses
            torch.save(state, os.path.join(work, "mesh_state.pt"))
        # the one-process checkpoint onto the four ranks
        lm2 = LM(cfg, device="cpu")
        place_parameters(lm2, mesh, rules_for("train"), torch.float32)
        st2 = init_train_state(lm2, opt)
        step, tree = load_checkpoint(os.path.join(work, "one"), mmap=True)
        load_train_tree(lm2, st2, tree)
        back = train_tree(lm2, st2)
        if rank == 0:
            torch.save(back, os.path.join(work, "one_on_mesh.pt"))
        # the reference's restore onto shardings (a matching tree of
        # NamedShardings): each rank holds its quarter of the embedding
        from repro_torch.checkpoint.store import _flatten, _unflatten
        from repro_torch.models.sharding import NamedSharding
        flat = _flatten(tree)
        manifest = json.load(open(os.path.join(
            work, "one", "step_00000002", "manifest.json")))
        shard = NamedSharding(mesh, ("data", "model"))
        shardings = _unflatten({k: NamedSharding(mesh, ()) for k in flat},
                               manifest)
        shardings["params"]["embed"] = shard
        _, placed = load_checkpoint(os.path.join(work, "one"),
                                    shardings=shardings)
        emb = placed["params"]["embed"]
        res["restore_onto_shardings"] = bool(
            isinstance(emb, DTensor) and emb.placements == shard.placements
            and list(emb.to_local().shape) == [tree["params"]["embed"]
                                               .shape[0] // 2,
                                               tree["params"]["embed"]
                                               .shape[1] // 2]
            and torch.equal(emb.full_tensor(), tree["params"]["embed"])
            and all(torch.equal(v.full_tensor(), flat[k]) for k, v in
                    _flatten(placed).items()))

        # int8 EF on DTensor gradients against the plain round trip
        gen = np.random.default_rng(5)
        params = dict(lm2.named_parameters())
        plain_g = {n: torch.from_numpy(gen.standard_normal(tuple(p.shape))
                                       .astype(np.float32) * (1 + i % 3))
                   for i, (n, p) in enumerate(params.items())}
        plain_e = {n: torch.zeros_like(v) for n, v in plain_g.items()}
        want_g, want_e, _ = compress.compress_decompress(plain_g, plain_e)
        dg = {n: distribute_tensor(plain_g[n], mesh, params[n].placements,
                                   src_data_rank=None) for n in params}
        de = compress.init_error_buffers(params)
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            got_g, got_e, _ = compress.compress_decompress(dg, de)
        res["ef_equal"] = all(
            torch.equal(got_g[n].full_tensor(), want_g[n])
            and torch.equal(got_e[n].full_tensor(), want_e[n])
            for n in params)
        res["ef_placed"] = all(isinstance(de[n], DTensor) and
                               de[n].placements == params[n].placements
                               for n in params)
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    work, out = sys.argv[1], sys.argv[2]
    from repro_torch import configs
    from repro_torch.launch import train as T
    from repro_torch.train import AdamWConfig
    from repro_torch.train import build_train_step as step_of
    T.build_train_step = lambda *a, **kw: step_of(*a, grad_dtype="float32",
                                                  **kw)
    cfg = configs.get_smoke(ARCH).replace(dtype="float64")
    opt = AdamWConfig(state_dtype="float32", total_steps=3, warmup_steps=0)
    # one process: a checkpoint the ranks restore, and the plain steps fed
    # the mesh's global batch (one data shard's slice, twice)
    T.train_loop(cfg, steps=2, save_every=2, opt=opt, device="cpu",
                 ckpt_dir=os.path.join(work, "one"), **RUN)
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import LM
    from repro_torch.train import build_train_step, init_train_state
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    st = init_train_state(lm, opt)
    step = build_train_step(lm, opt, grad_dtype="float32")
    half = SyntheticTokens(vocab=cfg.vocab, global_batch=4, seq_len=16,
                           data_shards=2)
    plain = []
    for i in range(3):
        b = {k: torch.from_numpy(np.concatenate([v, v]))
             for k, v in half.batch_at(i).items()}
        st, m = step(st, b)
        plain.append(float(m["loss"]))
    mp.spawn(rank_main, args=(os.path.join(work, "store"), work, out),
             nprocs=4)
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.train import load_train_tree, train_tree
    res = json.load(open(out))
    res["plain_losses"] = plain
    # the four ranks' checkpoint restored on one process
    lm1 = LM(cfg, device="cpu")
    st1 = init_train_state(lm1, opt)
    _, tree = load_checkpoint(os.path.join(work, "mesh"))
    load_train_tree(lm1, st1, tree)
    got = train_tree(lm1, st1)
    want = torch.load(os.path.join(work, "mesh_state.pt"))
    one = load_checkpoint(os.path.join(work, "one"))[1]
    back = torch.load(os.path.join(work, "one_on_mesh.pt"))

    def leaves(x, p=""):
        if isinstance(x, dict):
            for k in sorted(x):
                yield from leaves(x[k], p + "/" + k)
        else:
            yield p, x

    res["mesh_on_one"] = [p for (p, a), (_, b) in zip(leaves(got),
                                                       leaves(want))
                          if not torch.equal(a, b)]
    res["one_on_mesh"] = [p for (p, a), (_, b) in zip(leaves(one),
                                                       leaves(back))
                          if not torch.equal(torch.as_tensor(a), b)]
    res["n_leaves"] = len(list(leaves(want)))
    # the mesh's gathered state against the plain steps', leaf by leaf:
    # each element within 1e-5 of its leaf's rms plus 16 float32 ulps of
    # itself (the moments' own rounding)
    ref = train_tree(lm, st)
    assert [p for p, _ in leaves(ref)] == [p for p, _ in leaves(want)]
    errs = {}
    for (p, g), (_, w) in zip(leaves(want), leaves(ref)):
        g, w = g.double(), w.double()
        rms = w.pow(2).mean().sqrt()
        ulps = 16 * 2.0 ** -24 * w.abs()
        errs[p] = float(((g - w).abs() - ulps).clamp(min=0).max()
                        / (rms + 1e-30))
    res["state_errs"] = errs
    res["state_dtypes_differ"] = [p for (p, g), (_, w) in
                                  zip(leaves(want), leaves(ref))
                                  if g.dtype != w.dtype]
    with open(out, "w") as f:
        json.dump(res, f)
'''


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    work = tmp_path_factory.mktemp("meshtrain")
    script = work / "child.py"
    script.write_text(_CHILD)
    out = work / "res.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(script), str(work), str(out)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


def test_four_rank_losses_equal_a_plain_step_on_the_assembled_batch(result):
    got, want = result["losses"], result["plain_losses"]
    assert len(got) == len(want) == 3
    assert max(abs(g - w) / abs(w) for g, w in zip(got, want)) <= 1e-6


def test_four_rank_state_equals_the_plain_steps_leaf_by_leaf(result):
    errs = result["state_errs"]
    assert len(errs) == result["n_leaves"] > 10
    assert max(errs.values()) <= 1e-5, errs
    assert result["state_dtypes_differ"] == []


def test_the_2x2_split_assembles_the_global_batch(result):
    assert result["rows"] == [4, 16]
    assert result["quarter_refused"]


def test_checkpoints_cross_between_one_and_four_ranks(result):
    assert result["n_leaves"] > 10
    assert result["mesh_on_one"] == []
    assert result["one_on_mesh"] == []


def test_load_checkpoint_restores_onto_shardings(result):
    assert result["restore_onto_shardings"]


def test_int8_ef_on_the_mesh_takes_the_plain_scales(result):
    assert result["ef_placed"]
    assert result["ef_equal"]
