"""The port's entry-level process pool (``SuiteRunner(processes=2)``), on
the CPU: two spawned workers rebuild the registry from its ``refs`` and
``device`` markers and give the sequential rows, sharing their cells
through the store; every default and serving entry is eligible for the
pool, and a swapped generator under an unchanged name is not."""

import dataclasses

import pytest

from repro_torch.core import tracegen
from repro_torch.suite import (ResultStore, SuiteRunner, default_registry,
                               registry_for)

REFS = 2_000
CORES = (1, 4)


@pytest.fixture(scope="module")
def default():
    return default_registry(refs=REFS, device="cpu")


def test_every_entry_is_pool_eligible(default):
    serving = ("serving",)
    for reg, sections in ((default, ()), (registry_for(
            sections=serving, device="cpu"), serving)):
        runner = SuiteRunner(reg, cores=CORES, processes=2,
                             sections=sections)
        assert all(runner._reconstructible(e) for e in reg)
    # a serving roster run without its section rebuilds the default
    # roster in workers, which lacks its entries: they stay in-process
    runner = SuiteRunner(reg, cores=CORES, processes=2)
    assert not any(runner._reconstructible(e) for e in reg)


def _trimmed_registry():
    reg = default_registry(refs=REFS, device="cpu")
    keep = {"syn.stream.copy", "syn.chase.64MiB.e8", "pal.stream.copy.1MiB"}
    reg.entries = [e for e in reg.entries if e.name in keep]
    return reg


def test_processes_match_sequential(tmp_path):
    reg = _trimmed_registry()
    seq = SuiteRunner(_trimmed_registry(), cores=CORES).roster()
    store = ResultStore(tmp_path)
    par = SuiteRunner(reg, cores=CORES, store=store, processes=2)
    assert all(par._reconstructible(e) for e in reg)
    assert par.roster().rows == seq.rows
    assert par.stats.as_dict() == {"computed": 3, "recalled": 0}
    assert len(store.sub("cells")) > 0       # workers shared their cells
    rerun = SuiteRunner(reg, cores=CORES, store=store, processes=2)
    assert rerun.roster().rows == seq.rows
    assert rerun.stats.as_dict() == {"computed": 0, "recalled": 3}


def test_swapped_generator_runs_in_process():
    reg = _trimmed_registry()
    victim = reg.entries[0]
    donor = tracegen.make_suite(refs=REFS)[3]
    reg.entries[0] = dataclasses.replace(
        victim, workload=dataclasses.replace(victim.workload, gen=donor.gen))
    runner = SuiteRunner(reg, cores=CORES, processes=2)
    assert not runner._reconstructible(reg.entries[0])
    assert runner._reconstructible(reg.entries[1])
