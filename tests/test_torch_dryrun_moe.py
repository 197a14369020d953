"""The mini dry run (``tests/_torch_dryrun.py``) of the reference's
``TestMiniDryrun`` MoE cells: the deepseek-moe-16b smoke config,
``train_4k`` and ``decode_32k``, on a fake 2x2 mesh (tokens over "data",
experts over "model"): each ``ok`` with its exact argument bytes and
non-zero collective bytes."""

import pytest

from _torch_dryrun import SHAPES, check_entry, mini_dryrun

ARCHS = ("deepseek-moe-16b",)


@pytest.fixture(scope="module")
def entries():
    return mini_dryrun(ARCHS)


@pytest.mark.parametrize("shape", SHAPES)
def test_mini_dryrun_cell(entries, shape):
    check_entry(entries[f"deepseek-moe-16b:{shape}"],
                "train" if shape == "train_4k" else "decode")
