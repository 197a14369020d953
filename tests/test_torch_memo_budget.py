"""The simulator's memo budget is a knob in both packages.

The reference reads ``REPRO_MEMO_BYTES`` at import, the port
``REPRO_TORCH_MEMO_BYTES`` (its own name, since one process may import
both).  Given the same small budget, the same simulations evict the same
memos: the ``memo.evict`` and ``memo.bytes`` counters are equal.  Without
the knobs both budgets stay 256 MiB.  Each case runs in a fresh process,
since the budget is read once, at import.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = """
import json, numpy as np
from repro import obs as r_obs
from repro.core import cachesim as r_sim, cachesim_vec as r_vec
from repro_torch import obs as t_obs
from repro_torch.core import cachesim as t_sim, cachesim_vec as t_vec
arrays = [np.arange(4096, dtype=np.int64) * 5 + 777 * i for i in range(6)]
out = {}
for name, obs, sim, vec in (("repro", r_obs, r_sim, r_vec),
                            ("repro_torch", t_obs, t_sim, t_vec)):
    obs.reset_counters()
    rows = [list(vec.simulate(a, sim.host_config(1)).__dict__.values())
            for a in arrays + arrays[:2]]
    c = obs.counters()
    out[name] = {"budget": vec._MEMO_MAX_BYTES, "memos": len(vec._MEMOS),
                 "rows": repr(rows),
                 **{k: c.get(k, 0) for k in ("memo.evict", "memo.bytes",
                                             "memo.hit", "memo.miss")}}
print(json.dumps(out))
"""


def _run(env_budget: int | None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_MEMO_BYTES", "REPRO_TORCH_MEMO_BYTES")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    if env_budget is not None:
        env["REPRO_MEMO_BYTES"] = env["REPRO_TORCH_MEMO_BYTES"] = str(
            env_budget)
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("budget", [32 * 1024, 200 * 1024])
def test_same_budget_same_memo_counters(budget):
    got = _run(budget)
    ref, port = got["repro"], got["repro_torch"]
    assert ref["budget"] == port["budget"] == budget
    assert port["memo.evict"] >= 1
    for k in ("memo.evict", "memo.bytes", "memo.hit", "memo.miss", "memos",
              "rows"):
        assert port[k] == ref[k], k


def test_default_budget_unchanged():
    got = _run(None)
    assert got["repro"]["budget"] == got["repro_torch"]["budget"] == 256 * 2**20
    assert got["repro_torch"]["memo.evict"] == got["repro"]["memo.evict"] == 0
