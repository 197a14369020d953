"""The cross-package hold of the whole-model capture, shared by
``test_torch_capture_model.py`` (decode, prefill, eval) and
``test_torch_capture_train.py`` (train): one port capture against
``repro.capture.zoo.get_capture`` of the same (config, mode, batch).

- dense ops: the reference's (G, M, N, K) in program order; in train as a
  multiset with M and N unordered (autograd computes a weight's gradient
  as Xᵀ·G where jax's transpose of a swapped ``dot_general`` computes
  (Gᵀ·X)ᵀ, so M and N trade places in some backward products);
- dense FLOPs equal exactly;
- total FLOPs, whole-step refs and footprint within :data:`TOL`.

Where a cell misses, :data:`NAMED` names the lowering that causes it and
pins the measured deviation (within :data:`PIN`), so it can neither grow
nor vanish unnoticed.
"""

import collections

import numpy as np

from repro.capture import zoo as jax_zoo
from repro_torch.capture import zoo

TOL = 0.05        # total FLOPs, whole-step refs, footprint
PIN = 0.005       # a named deviation stays where it was measured

_SSD = ("the port's SSD chunk (models/ssm.py ssd_chunked) contracts the "
        "reference's three-operand einsums matrix first and keeps the "
        "intra-chunk tensors head-major, never forming the [B, Q, N, H] "
        "outer products: other products, fewer words")
_REUSE = ("regions are reused by program site (the next layer's op at the "
          "same line) where the reference reuses a scan-body variable's: "
          "the attention block's buffers split and reuse differently")
_BACKWARD = ("autograd's backward ops carry no Python frame, so their "
             "buffers are reused by node type and size across the whole "
             "backward pass, where the reference's transposed scan reuses "
             "them layer by layer and keeps its top-level values apart")

# (config, mode) -> {metric: (measured relative deviation, cause)}; metric
# "dense" means the dense ops differ (only the weight products are held).
NAMED = {
    ("nemotron-4-340b", "prefill"): {"footprint": (0.109, _REUSE)},
    ("nemotron-4-340b", "eval"): {"footprint": (0.087, _REUSE)},
    ("paligemma-3b", "prefill"): {"footprint": (-0.092, _REUSE)},
    ("paligemma-3b", "eval"): {"footprint": (-0.087, _REUSE)},
    ("zamba2-7b", "decode"): {"footprint": (0.094, _REUSE)},
    ("zamba2-7b", "prefill"): {"dense": (None, _SSD),
                               "refs": (-0.099, _SSD)},
    ("zamba2-7b", "eval"): {"dense": (None, _SSD), "refs": (-0.098, _SSD)},
    ("mamba2-780m", "prefill"): {"dense": (None, _SSD),
                                 "refs": (-0.114, _SSD)},
    ("mamba2-780m", "eval"): {"dense": (None, _SSD), "refs": (-0.112, _SSD),
                              "footprint": (-0.096, _SSD)},
    ("qwen2.5-14b", "train"): {"footprint": (-0.159, _BACKWARD)},
    ("mamba2-780m", "train"): {"dense": (None, _SSD), "refs": (0.102, _SSD),
                               "footprint": (-0.210, _BACKWARD)},
    ("zamba2-7b", "train"): {"dense": (None, _SSD), "refs": (0.092, _SSD),
                             "footprint": (-0.269, _BACKWARD)},
}

INFERENCE = [(c, m, 1) for c in jax_zoo._CONFIGS
             for m in ("decode", "prefill", "eval")]
TRAIN = [(c, "train", 4) for c in jax_zoo._TRAIN_CONFIGS]


def _geometry(op) -> tuple[int, int, int, int]:
    lhs, rhs = op.capture.operands[0].shape, op.capture.operands[1].shape
    return lhs[0], lhs[1], rhs[2], lhs[2]


def _unordered(g):
    return (g[0],) + tuple(sorted(g[1:3])) + (g[3],)


def _weight_products(dense, config: str):
    """The products of a weight: G = 1 with a (K, N) operand of a
    parameter's shape (its leading axis against the rest, or the rest
    against its last) — or, for a weight's gradient, (M, N)."""
    pairs = set()
    for p in zoo.meta_lm(config).parameters():
        if p.dim() >= 2:
            pairs.add((p.shape[0], int(np.prod(p.shape[1:]))))
            pairs.add((int(np.prod(p.shape[:-1])), p.shape[-1]))
    pairs |= {(b, a) for a, b in pairs}
    return collections.Counter(
        _unordered(g) for g in dense
        if g[0] == 1 and ((g[3], g[2]) in pairs or (g[1], g[2]) in pairs))


def hold(config: str, mode: str, batch: int) -> None:
    ref = jax_zoo.get_capture(config, mode, batch)
    got = zoo.get_capture(config, mode, batch)
    named = NAMED.get((config, mode), {})
    rd = [_geometry(op) for op in ref.ops if op.kind == "dense"]
    pd = [_geometry(op) for op in got.ops if op.kind == "dense"]
    if "dense" in named:
        assert _weight_products(rd, config) == _weight_products(pd, config)
        assert rd != pd                       # still the named difference
    else:
        if mode == "train":
            assert collections.Counter(map(_unordered, rd)) == \
                collections.Counter(map(_unordered, pd))
        else:
            assert rd == pd
        flops = lambda mc: sum(op.capture.flops for op in mc.ops  # noqa
                               if op.kind == "dense")
        assert flops(got) == flops(ref)
    totals = {
        "flops": (got.flops, ref.flops),
        "refs": (got.walk(count_only=True).refs,
                 ref.walk(count_only=True).refs),
        "footprint": (got.footprint_words, ref.footprint_words),
    }
    for metric, (p, r) in totals.items():
        rel = (p - r) / r
        if metric in named:
            pinned, cause = named[metric]
            assert abs(rel - pinned) <= PIN, (metric, rel, cause)
            assert abs(rel) > TOL, (metric, rel, "no longer a miss")
        else:
            assert abs(rel) <= TOL, (metric, rel)
