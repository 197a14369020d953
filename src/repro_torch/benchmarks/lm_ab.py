"""Time the plain LM's host-bound paths of one checkout of the port on the
card: decode steps, a prefill and a train step, each on seeded weights,
so that two versions of the model code can be compared on one card in
one call, in turns::

    git archive <parent> | tar -x -C build/parent
    for side in parent change change parent; do
        src=src; [ $side = parent ] && src=build/parent/src
        python3 src/repro_torch/benchmarks/lm_ab.py --src $src --label $side
    done

It is run as a file, not with ``-m``: it imports ``repro_torch`` from
``--src`` alone.

The cases (float32 parameters, the config's bf16 compute, as the serving
engine and the trainer hold them; each timed on the host clock between
synchronizes, median of ``STEPS`` after 3 warm-ups, a quarter of that
for the prefill and the train step, the train step after one):

- ``mamba2-780m`` decode, batch 8 against a 1024-row state (48 layers);
- ``qwen2.5-14b`` decode, batch 4 against a 1024-token cache, its full
  width on the first 12 of 48 layers;
- ``mamba2-780m`` prefill, batch 8 x 512;
- ``mamba2-780m`` train step, batch 8 x 1024, remat, AdamW with bf16
  moments (one step of ``train.build_train_step``).

Each run prints the card's name and power limit and one JSON line a case
with ``label``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
STEPS = 40


def timed(fn, steps: int, warm: int = 3) -> list[float]:
    import torch

    out = []
    for i in range(warm + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warm:
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 src/repro_torch/benchmarks/lm_ab.py")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    import repro_torch
    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.train import AdamWConfig, build_train_step, \
        init_train_state

    if not torch.cuda.is_available():
        print("lm_ab: no card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"

    def say(case: str, ms: list[float], **kw) -> None:
        print(json.dumps({"label": args.label, "case": case,
                          "src": str(Path(repro_torch.__file__).parent),
                          "median_ms": statistics.median(ms),
                          "min_ms": min(ms), "max_ms": max(ms),
                          "card": smi, **kw}), flush=True)

    def seeded(cfg) -> LM:
        return LM(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))

    def decode(cfg, batch: int, max_len: int) -> list[float]:
        lm = seeded(cfg)
        cache = lm.init_cache(batch, max_len)
        g = torch.Generator(device=dev).manual_seed(1)
        tok = torch.randint(0, cfg.vocab, (batch, 1), generator=g,
                            device=dev, dtype=torch.int32)
        pos = torch.full((batch,), max_len // 2, dtype=torch.int32,
                         device=dev)
        with torch.inference_mode():
            ms = timed(lambda: lm.decode_step(tok, cache, pos), STEPS)
        del lm, cache
        torch.cuda.empty_cache()
        return ms

    mamba = configs.get("mamba2-780m")
    say("mamba2-780m decode b8", decode(mamba, 8, 1024))
    qwen = configs.get("qwen2.5-14b").replace(n_layers=12)
    say("qwen2.5-14b decode b4 (12 of 48 layers)", decode(qwen, 4, 1024))

    lm = seeded(mamba)
    g = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, mamba.vocab, (8, 512), generator=g, device=dev,
                         dtype=torch.int32)
    with torch.inference_mode():
        ms = timed(lambda: lm.prefill(toks, lm.init_cache(8, 513)),
                   STEPS // 4)
    say("mamba2-780m prefill b8x512", ms)

    opt = AdamWConfig()
    state = init_train_state(lm, opt)
    step = build_train_step(lm, opt)
    batch = {k: torch.randint(0, mamba.vocab, (8, 1024), generator=g,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    box = [state]

    def train():
        box[0], _ = step(box[0], batch)
    say("mamba2-780m train b8x1024", timed(train, STEPS // 4,
                                           warm=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
