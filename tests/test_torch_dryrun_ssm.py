"""The mini dry run (``tests/_torch_dryrun.py``) of the reference's
``TestMiniDryrun`` SSM cells: the mamba2-780m smoke config,
``train_4k`` and ``decode_32k``, on a fake 2x2 mesh: each ``ok`` with its
exact argument bytes and non-zero collective bytes."""

import pytest

from _torch_dryrun import SHAPES, check_entry, mini_dryrun

ARCHS = ("mamba2-780m",)


@pytest.fixture(scope="module")
def entries():
    return mini_dryrun(ARCHS)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mini_dryrun_cell(entries, arch, shape):
    check_entry(entries[f"{arch}:{shape}"],
                "train" if shape == "train_4k" else "decode")
