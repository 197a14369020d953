"""Serving example: continuous batching over a slot-pool engine.

``python -m repro_torch.serve`` (counterpart of ``examples/serve_lm.py``):
submits a burst of variable-length prompts against a 4-slot engine over a
smoke config's LM drawn from seed 0 (more requests than slots — slots
recycle as requests finish), streams the tokens as they are emitted and
prints each request's output.

    python -m repro_torch.serve [--arch mamba2-780m] [--requests 6]
        [--max-new 8] [--device cuda|cpu]

The default ``--device cuda`` raises without a card.  The audio family
(whisper-large-v3) needs frame embeddings at prefill, which the engine
does not pass (neither does the reference's): for it the CLI hands the
engine an LM whose prefill takes seeded frames.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import LM

from .engine import Engine, FramedLM, Request


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", default="mamba2-780m", choices=configs.ARCHS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    lm = LM(cfg, device=args.device)
    lm.init(torch.Generator(device=lm.device).manual_seed(0))
    served = lm
    if cfg.family == "audio":
        g = torch.Generator(device=lm.device).manual_seed(0)
        served = FramedLM(lm, 0.1 * torch.randn(
            1, cfg.enc_ctx, cfg.d_model, generator=g, device=lm.device))
    engine = Engine(served, max_batch=4, max_len=64, prompt_buckets=(8, 16))

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(1, cfg.vocab,
                                           size=int(rng.integers(3, 14))),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    for r in reqs:
        engine.submit(r)

    step = 0
    with torch.inference_mode():
        while engine.queue or engine.active:
            emitted = engine.step()
            step += 1
            if emitted:
                print(f"step {step:3d}: " + "  ".join(
                    f"req{rid}->{tok}" for rid, tok in emitted))
    print("\nfinal outputs:")
    for r in reqs:
        print(f"  req{r.rid} ({len(r.prompt)}-token prompt): {r.out_tokens}")
    if not all(len(r.out_tokens) >= 1 for r in reqs):
        raise SystemExit("a request was served no token")
    print(f"served {len(reqs)} requests through 4 slots in {step} steps.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
