"""The port's configs and converter against the reference's.

- The ten ``CONFIG``/``SMOKE`` pairs, ``SHAPES`` and ``shapes_for`` equal
  the reference's field by field.
- ``convert`` round-trips the reference's parameters byte for byte and
  refuses a tree with a leaf missing, a leaf too many or a shape that
  differs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_lm import SMOKE_1A, ref_params
from repro import configs as ref_configs
from repro.models import config as ref_config
from repro_torch import configs
from repro_torch.models import LM, config
from repro_torch.models.convert import from_reference, to_reference


def _leaves(tree) -> dict[str, object]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): v for k, v in flat}


def _port(arch: str, seed: int = 0) -> LM:
    return LM(configs.get_smoke(arch), device="cpu").init(
        torch.Generator().manual_seed(seed))


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------
def test_arch_roster_equal():
    assert configs.ARCHS == ref_configs.ARCHS


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_configs_equal(arch, which):
    got = getattr(configs, which)(arch)
    want = getattr(ref_configs, which)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert configs.shapes_for(arch) == ref_configs.shapes_for(arch)


def test_shapes_equal():
    assert {k: dataclasses.asdict(v) for k, v in config.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_config.SHAPES.items()}


# --------------------------------------------------------------------------
# The converter
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v2-lite-16b",
                                  "paligemma-3b"])
def test_converter_round_trip_is_exact(arch):
    tree = ref_params(arch)
    lm = from_reference(tree, configs.get_smoke(arch), device="cpu")
    back = _leaves(to_reference(lm))
    want = _leaves(tree)
    assert list(back) == list(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes(), k
    # the stacked axis split: layer i of the port is row i of the leaf
    np.testing.assert_array_equal(
        lm.layers[1].attn.wo.numpy(), tree["layers"]["attn"]["wo"][1])


@pytest.mark.parametrize("arch", SMOKE_1A)
def test_port_parameters_round_trip_exactly(arch):
    lm = _port(arch)
    back = from_reference(to_reference(lm), lm.cfg, device="cpu")
    for (n, a), (m, b) in zip(lm.named_parameters(), back.named_parameters()):
        assert n == m and torch.equal(a, b), n


def test_converter_refuses_a_missing_an_extra_or_a_misshapen_leaf():
    cfg = configs.get_smoke("deepseek-moe-16b")
    tree = to_reference(_port("deepseek-moe-16b"))

    missing = jax.tree.map(lambda x: x, tree)
    del missing["layers"]["mixer"]["shared"]["w_up"]
    with pytest.raises(KeyError, match="shared.w_up"):
        from_reference(missing, cfg, device="cpu")

    extra = jax.tree.map(lambda x: x, tree)
    extra["layers"]["attn"]["bq"] = np.zeros((2, 4, 16), np.float32)
    with pytest.raises(KeyError, match="bq"):
        from_reference(extra, cfg, device="cpu")

    bad = jax.tree.map(lambda x: x, tree)
    bad["head"] = bad["head"][:, :-1]
    with pytest.raises(ValueError, match="head"):
        from_reference(bad, cfg, device="cpu")

    wrong_depth = jax.tree.map(lambda x: x, tree)
    wrong_depth["layers"]["ln1"]["scale"] = np.ones((3, cfg.d_model),
                                                   np.float32)
    with pytest.raises(ValueError, match="stacked"):
        from_reference(wrong_depth, cfg, device="cpu")
