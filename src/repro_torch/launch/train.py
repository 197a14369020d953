"""Training driver: data pipeline -> train step -> checkpoints, on one
card or on a ``DeviceMesh`` (the port of ``repro.launch.train``).

- every ``--save-every`` steps the full state ({"params", "opt"} in the
  reference's layout) is checkpointed atomically and asynchronously
  (``checkpoint/store.py``): its leaves are copied to host memory, each
  straight into its stacked place (on a mesh, each DTensor gathered into
  its global tensor first), then a thread writes them while the steps go
  on; on a mesh rank 0 alone writes;
- ``--resume`` restores the latest committed step's parameters,
  optimizer state *and* the data counter (the Philox stream needs only
  the step index);
- restore places leaves onto the *current* mesh: each rank copies its own
  shard out of the memory-mapped checkpoint, so a run comes back on
  another topology ("elastic scaling" is re-sharding on restore, not live
  membership change), and a checkpoint of the plain path, any mesh or the
  reference restores onto any other.

With ``mesh=`` the LM's parameters are placed by ``LM.axes()`` and the
training rules (f32 master weights), the optimizer state like its
parameters, every batch assembled by ``SyntheticTokens.global_arrays``
with the ``("batch", None, ...)`` spec, and the step runs under
``sharding.activate`` and DTensor's ``implicit_replication``, as
``launch.specs.build_cell`` runs a cell.  ``mesh=None`` is the plain
one-device path; it computes what the reference's 1x1 local mesh does.

CPU smoke (seconds)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --smoke --steps 20 --device cpu

Under ``torchrun`` (``WORLD_SIZE`` set) the CLI trains on
``make_local_mesh()`` over the launched ranks::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch mamba2-780m --smoke --steps 20 [--device cpu]

The default ``--device cuda`` raises without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticTokens, batch_shards
from repro_torch.device import resolve_device
from repro_torch.models import sharding
from repro_torch.models.model import LM
from repro_torch.models.shard_ops import whole
from repro_torch.train import (AdamWConfig, build_train_step,
                               init_train_state, load_train_tree, train_tree)

__all__ = ["main", "train_loop"]


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str | None = None, save_every: int = 50,
               resume: bool = False, microbatches: int = 1,
               opt: AdamWConfig | None = None, mesh=None,
               compress: str | None = None, log_every: int = 10,
               device: str | torch.device = "cuda"):
    """Train ``cfg`` for ``steps`` steps from parameters drawn from seed 0
    (or the latest checkpoint under ``resume``), on ``device`` or, given
    a ``DeviceMesh``, placed on it (``device`` is then the mesh's);
    returns (lm, opt_state, losses), the LM holding DTensor parameters on
    a mesh.  The losses come back as floats once the loop ends; inside it
    only a logging step waits for the card."""
    dev = resolve_device(device) if mesh is None else sharding.mesh_device(mesh)
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    opt = opt or AdamWConfig(total_steps=steps)
    running = contextlib.nullcontext
    shards = 0
    if mesh is not None:
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.launch.specs import place_parameters, rules_for

        rules = rules_for("train")
        place_parameters(lm, mesh, rules, torch.float32)
        batch_spec = sharding.logical_to_spec(mesh, ("batch", None),
                                              (global_batch, seq_len), rules)
        shards = batch_shards(mesh, batch_spec)

        @contextlib.contextmanager
        def running():
            with sharding.activate(mesh, rules), implicit_replication():
                yield
    opt_state = init_train_state(lm, opt, compress=compress)

    step0 = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3, async_save=True)
        if resume and mgr.latest_step() is not None:
            # on a mesh each rank copies its shard out of the mapped file
            step0, tree = (mgr.restore_latest(device=dev) if mesh is None
                           else mgr.restore_latest(mmap=True))
            load_train_tree(lm, opt_state, tree)
            del tree
            print(f"[resume] from step {step0}")

    pipe = SyntheticTokens(
        vocab=cfg.vocab, global_batch=global_batch, seq_len=seq_len,
        extra_embed_len=(cfg.n_img_tokens if cfg.family == "vlm" else
                         cfg.enc_ctx if cfg.family == "audio" else 0),
        d_model=cfg.d_model, data_shards=shards,
    ).start(step0)
    train_step = build_train_step(lm, opt, microbatches=microbatches,
                                  compress=compress)

    it = iter(pipe)
    losses = []
    t0 = time.time()
    try:
        for step in range(step0, steps):
            host = next(it)
            batch = ({k: torch.from_numpy(v).to(dev, non_blocking=True)
                      for k, v in host.items()} if mesh is None
                     else pipe.global_arrays(host, mesh, batch_spec))
            with running():
                opt_state, metrics = train_step(opt_state, batch)
            losses.append(metrics["loss"])
            if (step + 1) % log_every == 0:
                metrics = {k: whole(v) for k, v in metrics.items()}
                loss = float(whole(losses[-1]))
                dt = (time.time() - t0) / log_every
                tok_s = global_batch * seq_len / dt
                print(f"step {step+1:5d} loss {loss:.4f} "
                      f"{dt*1e3:7.1f} ms/step {tok_s:9.0f} tok/s "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
                t0 = time.time()
            if mgr and (step + 1) % save_every == 0:
                mgr.save(step + 1, train_tree(lm, opt_state))
        if mgr:
            mgr.save(steps, train_tree(lm, opt_state))
            mgr.wait()
    finally:
        pipe.stop()
    return lm, opt_state, [float(whole(x)) for x in losses]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", default=None, choices=[None, "int8_ef"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    run = dict(steps=args.steps, global_batch=args.batch, seq_len=args.seq,
               ckpt_dir=args.ckpt_dir, save_every=args.save_every,
               resume=args.resume, microbatches=args.microbatches,
               compress=args.compress)
    if "WORLD_SIZE" not in os.environ:
        train_loop(cfg, device=args.device, **run)
        return 0
    # launched by torchrun: one process a rank, the group from its env
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    dev = resolve_device(args.device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    try:
        with make_local_mesh(device=args.device) as mesh:
            train_loop(cfg, mesh=mesh, **run)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
