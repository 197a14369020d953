"""``launch.specs.build_cell`` on the 16x16 production mesh, held leaf
for leaf against the reference's sharding (``tests/_torch_launch_cells.py``):
every parameter, optimizer-state, cache and batch leaf of all 32 cells is
a ``meta`` DTensor whose local shard shape equals the reference's
``NamedSharding.shard_shape``; the fake process group is destroyed after
the module's fixture."""

import pytest

from _torch_launch_cells import (built_cells, check_donation_and_groups,
                                 check_every_leaf)


@pytest.fixture(scope="module")
def built():
    return "16x16", built_cells(False)


def test_every_leaf_shards_as_the_references(built):
    check_every_leaf(built)


def test_donation_and_argument_groups(built):
    check_donation_and_groups(built)
