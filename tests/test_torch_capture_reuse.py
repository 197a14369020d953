"""How ``repro_torch.capture.model`` reuses regions, as the reference's
walker reuses a scan-body variable's.

- Two iterations of a layer loop (a function called once an iteration)
  take the same regions, even while a value of the first iteration is
  still alive; two values of the step's own top level take two.
- A loop inside one call (unrolled at trace time in the reference too)
  takes a region for each of its values.
- The smoke train step's backward ops of layer i read and write where
  layer i + 1's did, except what the reference stacks over its layers: a
  residual of the forward pass and a parameter's gradient.
"""

import collections

import torch

from repro_torch.capture import zoo
from repro_torch.capture.model import capture_model


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _dense(mc):
    return [op for op in mc.ops if op.kind == "dense"]


def test_loop_iterations_share_regions_top_level_values_do_not():
    d = 128

    def fn(x, w):
        kept = []

        def layer(h):
            y = h @ w
            kept.append(y)          # the first iteration's value lives on
            return y

        for _ in range(2):
            x = layer(x)
        a = x @ w                   # two values of the top level
        b = x @ w
        return kept, a, b

    it0, it1, a, b = _dense(capture_model(fn, (_meta(d, d), _meta(d, d))))
    assert it1.bases["out"] == it0.bases["out"]
    assert it1.bases["lhs"] == it0.bases["out"]     # reads iteration 0's
    assert a.bases["out"] != b.bases["out"]
    assert len({a.bases["out"], b.bases["out"], it0.bases["out"]}) == 3


def test_a_loop_inside_one_call_takes_a_region_a_value():
    d = 128

    def fn(x, w):
        outs = []
        for _ in range(3):
            outs.append(x @ w)
        return outs

    ops = _dense(capture_model(fn, (_meta(d, d), _meta(d, d))))
    assert len({op.bases["out"] for op in ops}) == 3


def _geometry(op):
    return tuple(spec.shape for spec in op.capture.operands)


def _layer_blocks(ops):
    """The dense ops of the last two equal runs of dense geometries, back
    to back and as long as can be: the backward pass (a layer's
    recomputation, then its transposes) of the last layer, then of the
    layer before it."""
    geo = [_geometry(op) for op in ops]
    for n in range(len(geo) // 2, 0, -1):
        for start in range(len(geo) - 2 * n, -1, -1):
            if geo[start:start + n] == geo[start + n:start + 2 * n]:
                return ops[start:start + n], ops[start + n:start + 2 * n]
    raise AssertionError("no repeated layer block")


def test_train_backward_reuses_the_next_layers_regions():
    mc = zoo.get_capture("qwen2.5-14b", "train", 4)
    dense = _dense(mc)
    later, earlier = _layer_blocks(dense)
    vocab = zoo.meta_lm("qwen2.5-14b").cfg.vocab
    head = min(i for i, op in enumerate(dense)
               if op.capture.operands[2].shape[-1] == vocab)
    assert dense.index(later[0]) > head       # after the logits: backward
    assert len(later) >= 8
    shared = collections.Counter()
    for a, b in zip(later, earlier):
        for name in ("lhs", "rhs", "out"):
            shared[a.bases[name] == b.bases[name]] += 1
    # most operands are the backward body's variables, taken again; the
    # rest are the forward's residuals, the weights and their gradients,
    # one slot a layer
    assert shared[True] > shared[False] > 0
