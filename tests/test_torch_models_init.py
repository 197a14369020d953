"""The port's parameter init against the reference's: ``LM.init`` draws
the reference's tree (the same names, shapes, dtypes and parameter count
as ``jax.eval_shape(lm.init, key)``), each tensor's standard deviation
within 5% of the reference's draw (its ``truncated_normal(-2, 2) *
scale``, ``normal * d^-1/2``, ones and zeros) at the smoke sizes; the
analytic parameter count; configs sharing one parameter set.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_lm import KEY, SMOKE_1A, ref_params
from repro import configs as ref_configs
from repro.models import LM as RefLM
from repro_torch import configs
from repro_torch.models import LM
from repro_torch.models.convert import to_reference
from repro_torch.models.model import flat_spec


def _leaves(tree) -> dict[str, object]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): v for k, v in flat}


def _port(arch: str, seed: int = 0) -> LM:
    return LM(configs.get_smoke(arch), device="cpu").init(
        torch.Generator().manual_seed(seed))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SMOKE_1A)
def test_init_tree_equals_the_references(arch):
    want = _leaves(jax.eval_shape(RefLM(ref_configs.get_smoke(arch)).init,
                                  KEY))
    got = _leaves(to_reference(_port(arch)))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype == np.float32, k
    n = sum(p.numel() for p in _port(arch).parameters())
    assert n == sum(int(np.prod(v.shape)) for v in want.values())


@pytest.mark.parametrize("arch", SMOKE_1A)
def test_init_std_within_5pct_of_the_references(arch):
    want = _leaves(ref_params(arch))
    got = _leaves(to_reference(_port(arch)))
    for k, w in want.items():
        sw, sg = float(w.std()), float(got[k].std())
        if sw == 0.0:              # biases (zeros) and norm scales (ones)
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert abs(sg - sw) <= 0.05 * sw, (k, sg, sw)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v2-lite-16b"])
def test_truncated_draws_stop_at_two_scales(arch):
    """``truncated_normal(-2, 2) * scale``: every value within 2 scales,
    and the largest near that edge (the embedding and head are plain
    normals)."""
    lm = _port(arch)
    spec = flat_spec(lm.cfg)
    for name, p in lm.named_parameters():
        init = spec[name]
        if init.kind == "trunc":
            top = float(p.abs().max())
            assert 1.8 * init.scale < top <= 2.0 * init.scale * (1 + 1e-6), name
        else:
            assert init.kind in ("normal", "ones", "zeros"), name


def test_init_is_drawn_from_the_generator():
    a = to_reference(_port("qwen2.5-14b", seed=0))
    b = to_reference(_port("qwen2.5-14b", seed=0))
    c = to_reference(_port("qwen2.5-14b", seed=1))
    for k, v in _leaves(a).items():
        np.testing.assert_array_equal(v, _leaves(b)[k])
    assert not np.array_equal(a["embed"], c["embed"])


@pytest.mark.parametrize("arch", SMOKE_1A)
def test_param_count_analytic_matches_actual(arch):
    """tests/test_models.py's invariant, on the port."""
    cfg = configs.get_smoke(arch)
    actual = sum(p.numel() for p in LM(cfg, device="cpu").parameters())
    est = cfg.param_count()
    assert abs(actual - est) / actual < 0.15, (arch, actual, est)


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-780m",
                                  "whisper-large-v3"])
def test_families_of_the_next_slice_raise(arch):
    """The families that once raised here (they waited for the "LM
    stack, 1b" slice) build now, with the analytic parameter count; a
    family the LM does not know still raises."""
    cfg = configs.get_smoke(arch)
    actual = sum(p.numel() for p in LM(cfg, device="cpu").parameters())
    assert abs(actual - cfg.param_count()) / actual < 0.15
    with pytest.raises(ValueError, match="rnn"):
        LM(cfg.replace(family="rnn"), device="cpu")


def test_with_config_shares_the_parameters():
    lm = _port("deepseek-v2-lite-16b")
    f32 = lm.with_config(lm.cfg.replace(dtype="float32",
                                        moe_capacity_factor=64.0))
    assert f32.dtype == torch.float32 and lm.dtype == torch.bfloat16
    assert f32.cfg.moe_capacity_factor == 64.0
    assert lm.cfg.moe_capacity_factor == 1.25
    for (n, a), (m, b) in zip(lm.named_parameters(), f32.named_parameters()):
        assert n == m and a.data_ptr() == b.data_ptr()
    with pytest.raises(ValueError, match="shape"):
        lm.with_config(lm.cfg.replace(n_layers=3))
