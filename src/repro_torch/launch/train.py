"""Training driver on one card: data pipeline -> train step -> checkpoints.

The port of ``repro.launch.train`` without its mesh (sharding across
cards waits for ROADMAP.md's multi-card queue item):

- every ``--save-every`` steps the full state ({"params", "opt"} in the
  reference's layout) is checkpointed atomically and asynchronously
  (``checkpoint/store.py``): its leaves are copied to host memory, each
  straight into its stacked place, then a thread writes them while the
  steps go on;
- ``--resume`` restores the latest committed step's parameters,
  optimizer state *and* the data counter (the Philox stream needs only
  the step index).

CPU smoke (seconds)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --smoke --steps 20 --device cpu

The default ``--device cuda`` raises without a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models.model import LM
from repro_torch.train import (AdamWConfig, build_train_step,
                               init_train_state, load_train_tree, train_tree)

__all__ = ["main", "train_loop"]


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str | None = None, save_every: int = 50,
               resume: bool = False, microbatches: int = 1,
               opt: AdamWConfig | None = None, compress: str | None = None,
               log_every: int = 10, device: str | torch.device = "cuda"):
    """Train ``cfg`` for ``steps`` steps from parameters drawn on
    ``device`` from seed 0 (or the latest checkpoint under ``resume``);
    returns (lm, opt_state, losses).  The losses come back as floats once
    the loop ends; inside it only a logging step waits for the card."""
    dev = resolve_device(device)
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    opt = opt or AdamWConfig(total_steps=steps)
    opt_state = init_train_state(lm, opt, compress=compress)

    step0 = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3, async_save=True)
        if resume and mgr.latest_step() is not None:
            step0, tree = mgr.restore_latest(device=dev)
            load_train_tree(lm, opt_state, tree)
            del tree
            print(f"[resume] from step {step0}")

    pipe = SyntheticTokens(
        vocab=cfg.vocab, global_batch=global_batch, seq_len=seq_len,
        extra_embed_len=(cfg.n_img_tokens if cfg.family == "vlm" else
                         cfg.enc_ctx if cfg.family == "audio" else 0),
        d_model=cfg.d_model,
    ).start(step0)
    train_step = build_train_step(lm, opt, microbatches=microbatches,
                                  compress=compress)

    it = iter(pipe)
    losses = []
    t0 = time.time()
    try:
        for step in range(step0, steps):
            batch = {k: torch.from_numpy(v).to(dev, non_blocking=True)
                     for k, v in next(it).items()}
            opt_state, metrics = train_step(opt_state, batch)
            losses.append(metrics["loss"])
            if (step + 1) % log_every == 0:
                loss = float(losses[-1])
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
    return lm, opt_state, [float(x) for x in losses]


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
    train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, save_every=args.save_every,
        resume=args.resume, microbatches=args.microbatches,
        compress=args.compress, device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
