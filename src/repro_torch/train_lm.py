"""End-to-end training driver: train a (reduced) assigned architecture for
a few hundred steps with checkpointing and resume (the port's counterpart
of the reference's ``examples/train_lm.py``).

The full-size path is the same call with ``configs.get`` for
``configs.get_smoke``, on a ``DeviceMesh`` (``launch.train.train_loop(mesh=
...)``, or ``torchrun ... -m repro_torch.launch.train``), which this
driver wraps.

Run:  PYTHONPATH=src python -m repro_torch.train_lm [--arch qwen2.5-14b]
      PYTHONPATH=src python -m repro_torch.train_lm --kill-and-resume
      (``--device cpu`` without a card; the default ``cuda`` raises there)
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

from repro_torch import configs
from repro_torch.launch.train import train_loop

__all__ = ["main"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train_lm")
    ap.add_argument("--arch", default="qwen2.5-14b", choices=configs.ARCHS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--kill-and-resume", action="store_true",
                    help="demonstrate fault tolerance: run half, 'crash', "
                         "resume from the checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    run = dict(global_batch=8, seq_len=64, ckpt_dir=ckpt, log_every=20,
               device=args.device)

    if args.kill_and_resume:
        half = args.steps // 2
        print(f"--- phase 1: steps 0..{half} (then simulated failure) ---")
        train_loop(cfg, steps=half, save_every=20, **run)
        print("--- node 'failed'; restarting and resuming ---")
        _, _, losses = train_loop(cfg, steps=args.steps, save_every=50,
                                  resume=True, **run)
    else:
        _, _, losses = train_loop(cfg, steps=args.steps, save_every=100,
                                  **run)
    print(f"first-10 mean loss {sum(losses[:10]) / 10:.4f} -> "
          f"last-10 mean loss {sum(losses[-10:]) / 10:.4f}")
    assert sum(losses[-10:]) < sum(losses[:10]), "loss should decrease"
    print("training signal confirmed (loss decreased).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
