"""``launch.specs.build_cell``'s train step on a one-rank gloo mesh equals
the plain LM's train step bit for bit (``tests/test_torch_launch_local.py``
holds the serving cells and qwen2.5-14b's): the MoE family, whose routed
experts run on each rank's shard, and the SSM family, whose scan runs on
each rank's heads, two microbatches each."""

import pytest

from test_torch_launch_local import check_one_rank_step, no_group_left  # noqa: F401


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-780m"])
def test_one_rank_train_step_equals_the_plain_lm(arch):
    check_one_rank_step(arch, "train_4k")
