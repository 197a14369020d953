"""The port's data pipeline (``repro_torch.data``) against
``repro.data.SyntheticTokens``: batches byte-equal over seeds, steps,
shapes and extra embeddings; the prefetching iterator restarts from a
checkpointed step; the batch specs' shapes and dtypes; the process grid
without ``torch.distributed``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTokens as RefTokens
from repro_torch.data.pipeline import SyntheticTokens, make_batch_specs


def _pair(**kw):
    base = dict(vocab=512, global_batch=4, seq_len=32, seed=0)
    base.update(kw)
    return SyntheticTokens(**base), RefTokens(**base)


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("kw", [{}, {"vocab": 50280, "global_batch": 8,
                                     "seq_len": 64},
                                {"extra_embed_len": 6, "d_model": 8}],
                         ids=["smoke", "mamba2-vocab", "extra-embed"])
def test_batches_are_byte_equal_to_the_references(seed, kw):
    port, ref = _pair(seed=seed, **kw)
    for step in (0, 1, 7, 1000):
        a, b = port.batch_at(step), ref.batch_at(step)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (seed, step, k)


def test_labels_are_the_next_tokens():
    b = _pair()[0].batch_at(0)
    assert b["tokens"].dtype == b["labels"].dtype == np.int32
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 512
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_iterators_restart_from_a_checkpointed_step():
    port, ref = _pair(prefetch=2)
    it = iter(port)
    first = [next(it) for _ in range(2)]
    for i, b in enumerate(first):
        assert b["tokens"].tobytes() == ref.batch_at(i)["tokens"].tobytes()
    port.start(step=5)
    try:
        it = iter(port)
        got = [next(it) for _ in range(3)]
    finally:
        port.stop()
    assert port._q.empty()
    for i, b in enumerate(got):
        assert b["tokens"].tobytes() == ref.batch_at(5 + i)["tokens"].tobytes()
    port.start(step=2)
    try:
        b = next(iter(port))
    finally:
        port.stop()
    assert b["labels"].tobytes() == ref.batch_at(2)["labels"].tobytes()


def test_make_batch_specs_shapes_and_dtypes():
    cfg = SimpleNamespace(d_model=16, dtype="bfloat16")
    shape = SimpleNamespace(global_batch=8, seq_len=64)
    specs = make_batch_specs(cfg, shape)
    assert specs["tokens"].shape == specs["labels"].shape == (8, 64)
    assert specs["tokens"].dtype == torch.int32
    assert "extra_embed" not in specs
    vlm = make_batch_specs(cfg, shape, img_tokens=5)
    assert vlm["extra_embed"] == ((8, 5, 16), torch.bfloat16)
    audio = make_batch_specs(cfg, shape, enc_ctx=7)
    assert audio["extra_embed"].shape == (8, 7, 16)


def test_one_process_without_torch_distributed():
    port, _ = _pair(global_batch=6)
    assert not torch.distributed.is_initialized()
    assert (port._procs, port._pid, port._local_batch) == (1, 0, 6)
