"""Time the wide flash kernels' cluster exchange alone on the card.

Builds ``scripts/cluster_exchange.cu`` with ``nvcc`` (against the port's
``csrc/sm90.cuh``), checks that every block of every cluster summed the
cluster's partials exactly, then times each protocol with and without the
exchange at the launch geometry of PaliGemma-3B's attention (b 1, s 2048,
8 heads) at clusters of two and four: f32 ``flash_fwd_wide``'s (256
clusters of 64-row q tiles at two, walking 64 kv steps of 32 rows), and
the bf16 protocols a cluster ``flash_fwd_wide_sm90`` would need (128
clusters of 128-row q tiles at two, 32 kv tiles of 64 rows), each block
with about the kernel's shared memory, so one block an SM::

    python3 scripts/cluster_exchange.py [--out exchange.jsonl]

It prints the card's name and power limit, then one JSON line a
(protocol, variant, cluster size, work a tile): the bf16 exchange is tried
five ways (``PROTO_NAMES``: pulled after mbarriers waited at cluster or CTA
scope, pulled after a cluster barrier, pushed with ``st.async`` or as one
bulk copy a consumer from a send slot); ms with and without the exchange,
the exchange's microseconds a tile (a block's own partial comes from its
registers, the peers' through distributed shared memory),
``cudaOccupancyMaxActiveClusters``, and the tensor (or FMA) time the
recompute of S it replaces takes a tile at the card's peak (the part of
the head a block no longer multiplies at D 512).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.benchmarks.kernel_bench import (  # noqa: E402
    CardBench, card_identity)
from repro_torch.kernels import _build  # noqa: E402

SOURCE = Path(__file__).with_suffix(".cu")
SM_COUNT = 132
# Dependent multiply-adds a tile before the exchange: none (the exchange
# alone), and about a tile's products at D 512 (~1.75 us a warpgroup), so
# that what shows is the part of the exchange the work does not hide.
WORK = (0, 800)
PROTO_NAMES = ({1: "pull-acquire-cluster", 2: "pull-cta-wait-fence",
                3: "pull-cluster-barrier", 4: "push-st-async",
                5: "push-bulk-copy"},
               {1: "pull-cluster-barrier"})
# protocol -> (mode, clusters at a cluster of 2, tiles, shared bytes a
# block, the recompute a block's tile no longer does at D 512: (FLOP, the
# card's peak FLOP/s for its type))
PROTOCOLS = {
    "bf16": (0, 128, 32, 200_000, (2 * 128 * 64 * 256, 989e12)),
    "f32": (1, 256, 64, 160_000, (2 * 64 * 32 * 256, 67e12)),
}


def build(out_dir: Path) -> ctypes.CDLL:
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libcluster_exchange.so"
    cmd = _build.nvcc_command(SOURCE, lib)
    cmd[1:1] = ["-I", str(_build.CSRC)]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed:\n{log.stdout}{log.stderr}")
    dll = ctypes.CDLL(str(lib))
    v, i = ctypes.c_void_p, ctypes.c_int
    dll.cluster_exchange_launch.argtypes = [i, i, v, i, i, i, i, v, v, i]
    dll.cluster_exchange_launch.restype = i
    dll.repro_error_string.argtypes = [i]
    dll.repro_error_string.restype = ctypes.c_char_p
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cluster_exchange: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    smi = ", ".join(card_identity())
    print(smi, flush=True)
    dll = build(ROOT / "build" / "cluster_exchange")
    bench = CardBench()
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for name, (mode, clusters_1, tiles, smem, (flop, peak)) in \
            PROTOCOLS.items():
        for n in (2, 4):
            clusters = clusters_1 if n == 2 else clusters_1 // 2
            out = torch.zeros(clusters * n * 256, device="cuda")
            active = ctypes.c_int(0)

            def run(proto: int, work: int = 0, tiles: int = tiles,
                    active_ptr=None) -> None:
                err = dll.cluster_exchange_launch(
                    mode, proto, out.data_ptr(), clusters, n, tiles, smem,
                    stream, active_ptr, work)
                if err:
                    raise RuntimeError(dll.repro_error_string(err).decode())

            protos = (1,) if mode else (1, 2, 3, 4, 5) if n == 2 else (1, 2, 3)
            for proto in protos:
                run(proto, active_ptr=ctypes.byref(active))
                torch.cuda.synchronize()
                per = (32 if mode == 0 else 8)
                j = torch.arange(tiles, dtype=torch.float64)
                i = torch.arange(per, dtype=torch.float64)
                want = float((1024 * n * (n - 1) / 2
                              + n * (j[:, None] + i)).sum())
                got = out.double()
                if not bool((got == want).all()):
                    raise AssertionError(
                        f"{name} n={n} protocol {proto}: sums differ from "
                        f"{want}: {got.unique()[:8].tolist()}")
                for work in WORK:
                    with_x = bench.ms(lambda: run(proto, work))
                    without = bench.ms(lambda: run(0, work))
                    waves = clusters * n / SM_COUNT
                    line = {"phase": "cluster-exchange", "protocol": name,
                            "variant": PROTO_NAMES[mode][proto],
                            "cluster": n, "clusters": clusters,
                            "tiles": tiles, "work_fma_a_tile": work,
                            "ms": with_x, "ms_without": without,
                            "exchange_us_a_tile": 1e3 * (with_x - without)
                            / tiles / max(1.0, waves),
                            "tile_us_without": 1e3 * without / tiles
                            / max(1.0, waves),
                            "waves": waves,
                            "max_active_clusters": active.value,
                            "recompute_us_a_tile_at_peak": 1e6 * flop
                            * SM_COUNT / peak,
                            "card": smi}
                    print(json.dumps(line), flush=True)
                    lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
