"""``python -m repro_torch.benchmarks.dryrun_ablation --smoke``: the port
as it is and with one ``shard_ops`` piece put back to DTensor's own
strategy, each a dry-run step on a fake 2x2 mesh in a process of its own.
Both run; the vocab-parallel logsumexp moves fewer collective bytes than
DTensor's gather of the logits, and nothing else changes the argument
bytes."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_swapping_a_piece_changes_only_its_layout():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.dryrun_ablation",
         "--smoke", "--cells", "mamba2-780m:train_4k",
         "--only", "none,logsumexp_last", "--workers", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rows = {r["piece"]: r for r in map(json.loads, res.stdout.splitlines())}
    assert set(rows) == {"none", "logsumexp_last"}
    assert all(r["status"] == "ok" for r in rows.values()), rows
    none, plain = rows["none"], rows["logsumexp_last"]
    assert none["arg_bytes"] == plain["arg_bytes"]
    assert 0 < none["collective_bytes"] < plain["collective_bytes"]
    assert "all-gather" in plain["collective_by_op"]
