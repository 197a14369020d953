"""The port's kernel entry points on the CPU (their plain PyTorch versions)
against the reference Pallas kernels in interpret mode, on the same
seeded numpy inputs, at the tolerances of ``tests/test_kernels.py``:
flash and paged f32 atol 2e-5 / rtol 1e-4, STREAM f32 rtol 1e-5 /
atol 1e-6, bf16 2e-2, gather exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_kv_decode import paged_decode_attention as jax_paged
from repro.kernels.stream import (stream_add, stream_copy, stream_scale,
                                  stream_triad)
from repro.kernels.token_gather import gather_rows as jax_gather
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import mha
from repro_torch.kernels.paged_kv_decode import paged_decode
from repro_torch.kernels.stream import ops as stream_ops
from repro_torch.kernels.token_gather import gather

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a CPU torch tensor."""
    if dtype == "bfloat16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


# --------------------------------------------------------------------------
# STREAM
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_matches_reference(n_blocks, dtype):
    rng = np.random.default_rng(n_blocks)
    n = 512 * 128 * n_blocks
    ja, ta = _pair(_normal(rng, (n,)), dtype)
    jb, tb = _pair(_normal(rng, (n,)), dtype)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else BF16
    pairs = [
        (stream_copy(ja, interpret=True), stream_ops.stream_copy(ta)),
        (stream_scale(ja, 3.0, interpret=True),
         stream_ops.stream_scale(ta, 3.0)),
        (stream_add(ja, jb, interpret=True), stream_ops.stream_add(ta, tb)),
        (stream_triad(ja, jb, 3.0, interpret=True),
         stream_ops.stream_triad(ta, tb, 3.0)),
    ]
    for want, got in pairs:
        assert got.dtype == ta.dtype and got.shape == ta.shape
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_stream_2d_input_and_tile_guard():
    rng = np.random.default_rng(0)
    ja, ta = _pair(_normal(rng, (512, 256)), "float32")
    np.testing.assert_allclose(_np(stream_ops.stream_copy(ta)),
                               _np(stream_copy(ja, interpret=True)),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="tiles"):
        stream_ops.stream_copy(torch.zeros(1000))


# --------------------------------------------------------------------------
# token gather
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(64, 128), (256, 256), (128, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_matches_reference(shape, dtype):
    n, d = shape
    rng = np.random.default_rng(n + d)
    jt, tt = _pair(_normal(rng, shape), dtype)
    idx = rng.integers(0, n, size=3 * n // 2).astype(np.int32)
    want = jax_gather(jt, jnp.asarray(idx), interpret=True)
    got = gather(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gather_repeated_and_boundary_indices():
    table = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
    idx = np.array([0, 63, 0, 0, 63, 31], np.int32)
    want = jax_gather(jnp.asarray(table), jnp.asarray(idx), interpret=True)
    got = gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got), table[idx])


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------
FLASH_CASES = [
    # (b, sq, sk, h, g, d, causal)
    (1, 128, 128, 1, 1, 64, True),
    (2, 256, 256, 4, 2, 64, True),      # GQA, 2 kv tiles
    (1, 256, 256, 4, 1, 128, False),    # MQA, non-causal, D=128
    (1, 384, 384, 6, 2, 64, True),      # 3 kv tiles
    (1, 128, 256, 4, 4, 64, False),     # cross-shaped (sq != sk)
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_matches_reference_f32(case):
    b, sq, sk, h, g, d, causal = case
    rng = np.random.default_rng(sq + sk + h)
    jq, tq = _pair(_normal(rng, (b, sq, h, d)), "float32")
    jk, tk = _pair(_normal(rng, (b, sk, g, d)), "float32")
    jv, tv = _pair(_normal(rng, (b, sk, g, d)), "float32")
    want = jax_flash(jq, jk, jv, causal=causal, interpret=True)
    got = mha(tq, tk, tv, causal=causal)
    assert got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_flash_matches_reference_bf16():
    rng = np.random.default_rng(7)
    jq, tq = _pair(_normal(rng, (1, 256, 4, 64)), "bfloat16")
    jk, tk = _pair(_normal(rng, (1, 256, 2, 64)), "bfloat16")
    jv, tv = _pair(_normal(rng, (1, 256, 2, 64)), "bfloat16")
    want = jax_flash(jq, jk, jv, causal=True, interpret=True)
    got = mha(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_flash_extreme_logits_stay_finite():
    """Large scores exercise the -1e30 masked online softmax."""
    rng = np.random.default_rng(3)
    jq, tq = _pair(_normal(rng, (1, 128, 2, 64), 30.0), "float32")
    jk, tk = _pair(_normal(rng, (1, 128, 2, 64), 30.0), "float32")
    jv, tv = _pair(_normal(rng, (1, 128, 2, 64)), "float32")
    want = jax_flash(jq, jk, jv, causal=True, interpret=True)
    got = mha(tq, tk, tv, causal=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-3)


# --------------------------------------------------------------------------
# paged-KV decode
# --------------------------------------------------------------------------
PAGED_CASES = [
    # (h, d, n_pages, page, n_active)
    (1, 128, 32, 16, 8),      # MQA decode
    (8, 128, 64, 32, 16),     # GQA group of 8
    (4, 256, 16, 8, 16),      # every page active
    (2, 128, 64, 16, 1),      # single-page sequence
]


def _paged_inputs(case, dtype="float32"):
    h, d, n_pages, page, n_active = case
    rng = np.random.default_rng(h * 1000 + n_pages)
    q = _pair(_normal(rng, (h, d)), dtype)
    kp = _pair(_normal(rng, (n_pages, page, d)), dtype)
    vp = _pair(_normal(rng, (n_pages, page, d)), dtype)
    pt = rng.permutation(n_pages)[:n_active].astype(np.int32)
    return q, kp, vp, pt


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_decode_matches_reference(case, reverse):
    (jq, tq), (jk, tk), (jv, tv), pt = _paged_inputs(case)
    if reverse:
        pt = pt[::-1].copy()
    want = jax_paged(jq, jk, jv, jnp.asarray(pt), interpret=True)
    got = paged_decode(tq, tk, tv, torch.from_numpy(pt))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_paged_decode_matches_reference_bf16():
    (jq, tq), (jk, tk), (jv, tv), pt = _paged_inputs((4, 128, 32, 16, 8),
                                                     "bfloat16")
    want = jax_paged(jq, jk, jv, jnp.asarray(pt), interpret=True)
    got = paged_decode(tq, tk, tv, torch.from_numpy(pt))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("kernel", ["token_gather", "paged_kv_decode"])
def test_out_of_range_index_raises(kernel):
    """An index past the table raises on the CPU; on the card the kernel
    traps instead of reading past it (chip_smoke.py checks that)."""
    bad = torch.tensor([1, 4], dtype=torch.int32)
    with pytest.raises(IndexError):
        if kernel == "token_gather":
            gather(torch.zeros(4, 128), bad)
        else:
            pool = torch.zeros(4, 16, 128)
            paged_decode(torch.zeros(1, 128), pool, pool, bad)


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain versions: no launch counter moves."""
    before = launch_counts()
    stream_ops.stream_copy(torch.zeros(512 * 128))
    gather(torch.zeros(4, 128), torch.tensor([0, 3]))
    assert launch_counts() == before
