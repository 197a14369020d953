"""``repro_torch.capture.model`` against ``repro.capture.model``.

- The walker's algebra, as the reference's tests hold it
  (``tests/test_capture_model.py``): dot geometry and FLOPs, weights
  shared across layers with each layer's slice of a stacked operand at
  its offset, transparent aliasing, the stream threshold, contiguous
  windows, footprint, ``walk_stream`` concatenating to ``walk``, and the
  ``capture.model.*`` counters.
- A one-kernel step walks byte for byte like that kernel's standalone
  capture.
- A step captured with real tensors and on ``meta`` is the same capture.
- The cross-package hold (``tests/_torch_capture_hold.py``): the 10
  smoke configs in decode, prefill and eval at batch 1 and default
  geometry, each against ``repro.capture.zoo.get_capture`` (train:
  ``test_torch_capture_train.py``).
"""

import numpy as np
import pytest
import torch

from _torch_capture_hold import INFERENCE, hold
from repro_torch.capture import zoo
from repro_torch.capture.grid import walk
from repro_torch.capture.launch import capture_launch
from repro_torch.capture.model import (STREAM_MIN_ELEMS, ModelCapture,
                                       capture_model)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _dense(mc: ModelCapture):
    return [op for op in mc.ops if op.kind == "dense"]


# --------------------------------------------------------------------------
# The walker's algebra
# --------------------------------------------------------------------------
def test_dot_lowering_geometry_and_flops():
    mc = capture_model(lambda x, y: x @ y, (_meta(256, 512), _meta(512, 128)))
    (op,) = _dense(mc)
    g, mi, ni, ki = op.capture.grid
    assert g == 1 and mi * ni * ki > 1          # tiled, k innermost
    assert mc.flops == 2.0 * 256 * 128 * 512
    r = mc.walk()
    assert r.refs == r.addresses.size > 0


def test_layers_share_a_stacked_operand_at_offsets():
    """A layer loop over slices of one stacked operand reads each slice at
    its offset in the stacked region (the reference's scan xs slices); a
    shared operand keeps one region."""
    n_layers, d = 4, 128

    def fn(x, stacked, shared):
        for i in range(n_layers):
            x = (x @ stacked[i]) @ shared
        return x

    mc = capture_model(fn, (_meta(d, d), _meta(n_layers, d, d),
                            _meta(d, d)))
    ops = _dense(mc)
    assert len(ops) == 2 * n_layers                 # unrolled
    rhs = [op.bases["rhs"] for op in ops[0::2]]
    stride = d * d // 2                             # words of one slice
    assert [b - rhs[0] for b in rhs] == [i * stride for i in range(4)]
    assert len({op.bases["rhs"] for op in ops[1::2]}) == 1


def test_transparent_alias_threads_producer_to_consumer():
    d = 64

    def fn(x, y, z):
        t = torch.tanh(x @ y)      # small elementwise: aliases the dot out
        return t @ z

    d1, d2 = _dense(capture_model(fn, (_meta(d, d),) * 3))
    assert d2.bases["lhs"] == d1.bases["out"]


def test_stream_lowering_threshold():
    mc_big = capture_model(lambda x, y: x + y,
                           (_meta(256, 256), _meta(256, 256)))
    mc_small = capture_model(lambda x, y: x + y, (_meta(32, 32),
                                                   _meta(32, 32)))
    assert [op.kind for op in mc_big.ops] == ["stream"]
    assert mc_small.ops == ()
    assert 256 * 256 * 3 >= STREAM_MIN_ELEMS > 32 * 32 * 3
    r = mc_big.walk()
    assert r.loads == 2 * 256 * 256 // 2        # two arrays read
    assert r.stores == 256 * 256 // 2           # one written
    assert mc_big.flops == 256 * 256


def test_in_place_cache_write_moves_no_words():
    def fn(cache, x):
        cache[1].copy_(x)
        cache[:, 0].index_copy_(0, torch.zeros(1, dtype=torch.long,
                                               device=x.device), x[:1])

    mc = capture_model(fn, (_meta(4, 64, 256), _meta(64, 256)))
    assert mc.ops == () and mc.flops == 0.0


def _chain(x, y):
    return torch.tanh(x @ y) @ y


def test_walk_window_is_contiguous_slice():
    mc = capture_model(_chain, (_meta(256, 256),) * 2)
    full = mc.walk()
    target = full.refs // 3
    win = mc.walk_window(target)
    assert win.addresses.size == win.refs == target
    start = int((full.refs - target) * 0.5)
    assert np.array_equal(win.addresses, full.addresses[start:start + target])
    assert mc.walk_window(full.refs * 2).refs == full.refs


def test_footprint_grows_with_distinct_regions():
    one = capture_model(lambda x, y: x @ y, (_meta(128, 128),) * 2)
    two = capture_model(lambda x, y, z: (x @ y) @ z, (_meta(128, 128),) * 3)
    assert two.footprint_words > one.footprint_words > 0


def test_walk_stream_blocks_concat_to_walk():
    mc = capture_model(_chain, (_meta(256, 256),) * 2)
    full = mc.walk()
    blocks = list(mc.walk_stream())
    assert len(blocks) > 1
    assert np.array_equal(np.concatenate(blocks), full.addresses)
    target = full.refs // 3
    assert np.array_equal(np.concatenate(list(mc.walk_stream(target))),
                          mc.walk_window(target).addresses)
    over = np.concatenate(list(mc.walk_stream(full.refs * 2)))
    assert np.array_equal(over, full.addresses)
    with pytest.raises(ValueError):
        next(mc.walk_stream(0))


def test_counters():
    from repro_torch import obs

    mc = capture_model(lambda x, y: x @ y, (_meta(256, 256),) * 2)
    obs.reset_counters()
    list(mc.walk_stream())
    c = obs.counters()
    assert c["capture.model.stream_blocks"] > 0
    assert "capture.model.concat" not in c
    obs.reset_counters()
    mc.walk()
    mc.walk_window(100)
    assert obs.counters()["capture.model.concat"] == 2


# --------------------------------------------------------------------------
# A kernel launched inside a step; real tensors against meta
# --------------------------------------------------------------------------
def test_one_kernel_step_is_its_standalone_capture():
    from repro_torch.kernels.stream import stream_triad

    n = 512 * 128 * 4
    a = torch.ones(n)
    fn = lambda x, y: stream_triad(x, y, 1.5, block_rows=512)  # noqa: E731
    solo = walk(capture_launch(lambda: fn(a, a), torch.device("cpu")))
    mc = capture_model(fn, (a, a), name="gate")
    (op,) = mc.ops
    assert op.kind == "pallas"
    got = mc.walk()
    assert np.array_equal(got.addresses, solo.addresses)
    assert (got.loads, got.stores) == (solo.loads, solo.stores)
    assert mc.flops == solo.flops == got.flops


@pytest.mark.parametrize("config", ["qwen2.5-14b", "zamba2-7b"])
def test_real_tensors_capture_like_meta(config):
    from repro_torch import configs
    from repro_torch.models.model import LM

    lm = LM(configs.get_smoke(config), device="cpu").init(
        torch.Generator().manual_seed(0))
    real = zoo.capture_decode(lm, 2, 256, name="cpu")
    meta = zoo.capture_decode(zoo.meta_lm(config), 2, 256, name="meta")
    key = lambda mc: [(o.kind, o.capture.name, o.capture.grid,  # noqa: E731
                       o.bases) for o in mc.ops]
    assert key(real) == key(meta)
    assert (real.flops, real.footprint_words) == (meta.flops,
                                                  meta.footprint_words)
    assert np.array_equal(real.walk().addresses, meta.walk().addresses)


# --------------------------------------------------------------------------
# The cross-package hold
# --------------------------------------------------------------------------
@pytest.mark.parametrize("config,mode,batch", INFERENCE,
                         ids=[f"{c}.{m}" for c, m, _ in INFERENCE])
def test_hold_against_reference_capture(config, mode, batch):
    hold(config, mode, batch)
