"""``repro_torch.benchmarks.timing_smoke`` against the reference's
``benchmarks.timing_smoke``: the same families, and the same verdict at a
budget every cold cell meets and at one none can."""

import io

import pytest

from benchmarks import timing_smoke as jax_smoke
from repro_torch.benchmarks import timing_smoke


def test_families_are_the_references():
    cells = timing_smoke.family_cells(refs=2_000)
    assert len(cells) == 7
    assert timing_smoke.REFS == jax_smoke.REFS == 250_000


@pytest.mark.parametrize("budget,rc", [("100", 0), ("0.000001", 1)])
def test_verdict_equals_reference(budget, rc, capfd):
    assert timing_smoke.main(["--budget", budget]) == rc
    got = capfd.readouterr()
    assert jax_smoke.main(["--budget", budget]) == rc
    want = capfd.readouterr()
    fam = lambda text: [line.split()[0] for line in  # noqa: E731
                        text.splitlines() if "=" in line]
    assert fam(got.out) == fam(want.out)
    assert (got.err.count("FAIL:") == want.err.count("FAIL:"))


def test_compare_floors():
    times = {"a": {"vectorized": 0.1, "reference": 2.0},
             "b": {"vectorized": 0.2, "reference": 0.4}}
    kw = dict(budget=2.0, compare=True, out=io.StringIO(),
              err=io.StringIO())
    assert timing_smoke.verdict(times, ("vectorized",), **kw) == 0
    assert timing_smoke.verdict(times, ("vectorized",), min_speedup=9.0,
                                **kw) == 1      # aggregate 2.4 / 0.3 = 8x
    assert timing_smoke.verdict(times, ("vectorized",),
                                min_best_speedup=21.0, **kw) == 1
    over = {"a": {"vectorized": 2.5}}
    assert timing_smoke.verdict(over, ("vectorized",), budget=2.0,
                                compare=False, out=io.StringIO(),
                                err=io.StringIO()) == 1


def test_unknown_backend_is_refused():
    with pytest.raises(SystemExit):
        timing_smoke.main(["--backend", "jax2"])
