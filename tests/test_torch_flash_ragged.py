"""Flash attention at every sequence length on the CPU.

- The port's ``mha`` against the reference's ``mha`` at Sq, Sk in {1, 37,
  100, 200, 300} crossed, GQA, causal and not, f32 (atol 2e-5, rtol 1e-4)
  and bf16 (2e-2), and at head widths 192 and 320 on a few of them.  The
  reference sends lengths that are not multiples of 128 to its oracle; the
  port computes them as well (on the card, through the kernels).
- The ragged-tile arithmetic of the four forward kernels
  (``csrc/flash_attention.cu``), emulated in ``tests/_torch_flash_emulation
  .py``: the last q tile and the last kv tile partial, their rows past the
  end zeros, the scores of kv rows past Sk masked to -1e30, the rows past
  Sq dropped; f32 ``flash_fwd_kernel`` (also cut into kv ranges and
  combined) and ``flash_fwd_wide``, bf16 ``flash_fwd_sm90`` and
  ``flash_fwd_wide_sm90``, each held to the reference's oracle.
- ``record()``: the kernel-level ``flash_attention`` emits the
  reference's launch spec where the reference's Pallas kernel has a
  geometry (``min(block, S)`` dividing S, walked equal to the reference's
  mirror geometry) and raises, emitting none, elsewhere; ``mha`` emits it
  only on the reference's kernel route (Sq, Sk % 128 == 0, D % 8 == 0).
- The f32 split plan covers a ragged kv axis with whole-tile ranges.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flash_emulation import (kernel_emulation, keep_mask, pad_seq,
                                    sm90_emulation, wide_kernel_emulation,
                                    wide_sm90_emulation)
from repro.capture.grid import walk as jax_walk
from repro.kernels.flash_attention import attention_ref as jax_ref
from repro.kernels.flash_attention import mha as jax_mha
from repro.kernels.flash_attention.capture import capture as jax_capture
from repro_torch.capture.grid import walk
from repro_torch.capture.launch import record
from repro_torch.kernels.flash_attention import (attention_ref,
                                                flash_attention, mha)
from repro_torch.kernels.flash_attention.kernel import kernel_path
from repro_torch.kernels.flash_attention.ops import (has_geometry,
                                                    uses_kernel)
from repro_torch.kernels.flash_attention.plan import (f32_tiles,
                                                      padded_head_dim,
                                                      split_plan,
                                                      wide_f32_plan)

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
H100_SMS = 132
LENGTHS = (1, 37, 100, 200, 300)
# (b, h, g): GQA, two query heads a kv head
HEADS = (1, 4, 2)


def _inputs(sq: int, sk: int, d: int, *, b: int = 1, h: int = 4,
            g: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed + 7 * sq + 3 * sk + d)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    return q, k, v


def _jax(x: np.ndarray, dtype: str):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if dtype == "bfloat16" else a


def _torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


# --------------------------------------------------------------------------
# the port's mha against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", list(itertools.product(LENGTHS, LENGTHS)))
def test_mha_matches_reference_at_ragged_lengths(sq, sk, causal, dtype):
    q, k, v = _inputs(sq, sk, 64)
    want = jax_mha(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                   causal=causal)
    got = mha(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
              causal=causal)
    assert got.shape == (1, sq, 4, 64)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want),
                               **(BF16 if dtype == "bfloat16" else F32))


@pytest.mark.parametrize("d", [192, 320])
@pytest.mark.parametrize("sq,sk,causal", [(200, 300, True), (37, 100, False),
                                          (300, 37, True)])
def test_mha_matches_reference_at_ragged_lengths_wide_heads(sq, sk, causal,
                                                            d):
    q, k, v = _inputs(sq, sk, d, h=2, g=1)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal)
    got = mha(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_mha_at_whisper_encoder_length():
    """whisper-large-v3's encoder: 1500 positions, non-causal (one head of
    its 20 at D 64 here)."""
    q, k, v = _inputs(1500, 1500, 64, h=1, g=1)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=False)
    got = mha(*(torch.from_numpy(x) for x in (q, k, v)), causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# --------------------------------------------------------------------------
# the kernels' ragged tiles, emulated
# --------------------------------------------------------------------------
EMULATED = [(1, 1), (37, 100), (100, 37), (300, 37), (129, 65)]


def _oracle(q, k, v, causal: bool, dtype: str) -> np.ndarray:
    return _np(jax_ref(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                       causal=causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", EMULATED)
@pytest.mark.parametrize("d", [64, 192])
def test_f32_kernel_ragged_tiles(d, sq, sk, causal):
    q, k, v = _inputs(sq, sk, d)
    want = _oracle(q, k, v, causal, "float32")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    dp = padded_head_dim(d)
    plan_per, _ = split_plan(*HEADS[:2], sq, sk, n_sm=H100_SMS, d=dp)
    chunk = f32_tiles(dp)[1]
    for per in sorted({plan_per, -(-sk // chunk) * chunk}):
        got = kernel_emulation(tq, tk, tv, causal=causal, per=per)
        assert got.shape == tq.shape
        np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", EMULATED)
@pytest.mark.parametrize("d", [64, 192])
def test_sm90_kernel_ragged_tiles(d, sq, sk, causal):
    q, k, v = _inputs(sq, sk, d)
    want = _oracle(q, k, v, causal, "bfloat16")
    got = sm90_emulation(*(_torch(x, "bfloat16") for x in (q, k, v)),
                         causal=causal)
    assert got.shape == (1, sq, 4, d) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, **BF16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(1, 1), (37, 100), (100, 37), (65, 33)])
def test_wide_f32_kernel_ragged_tiles(sq, sk, causal):
    d = 320
    q, k, v = _inputs(sq, sk, d, h=2, g=1)
    want = _oracle(q, k, v, causal, "float32")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    chunk = wide_f32_plan(padded_head_dim(d)).kv_rows
    for per in sorted({chunk, -(-sk // chunk) * chunk}):
        got = wide_kernel_emulation(tq, tk, tv, causal=causal, per=per)
        np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(1, 1), (37, 100), (130, 37)])
def test_wide_sm90_kernel_ragged_tiles(sq, sk, causal):
    d = 320
    q, k, v = _inputs(sq, sk, d, h=2, g=1)
    want = _oracle(q, k, v, causal, "bfloat16")
    got = wide_sm90_emulation(*(_torch(x, "bfloat16") for x in (q, k, v)),
                              causal=causal)
    np.testing.assert_allclose(_np(got), want, **BF16)


def test_keep_mask_covers_the_tail_and_the_diagonal():
    # a whole tile below the diagonal and before Sk keeps every score
    assert keep_mask(128, 64, 0, 64, 256, True) is None
    keep = keep_mask(0, 4, 0, 8, 6, True)
    want = torch.tensor([[q >= k and k < 6 for k in range(8)]
                         for q in range(4)])
    assert torch.equal(keep, want)
    keep = keep_mask(0, 2, 64, 64, 100, False)
    assert keep[:, :36].all() and not keep[:, 36:].any()


def test_pad_seq_rounds_up_to_whole_tiles_with_zeros():
    x = torch.ones(2, 37, 3, 8)
    y = pad_seq(x, 32)
    assert y.shape == (2, 64, 3, 8)
    assert torch.equal(y[:, :37], x) and not y[:, 37:].any()


# --------------------------------------------------------------------------
# the launch spec where the reference has a geometry, none elsewhere
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sq,sk,block_q,block_k", [
    (256, 384, 128, 128), (100, 37, 128, 128), (128, 1, 128, 128),
    (512, 256, 256, 128), (64, 64, 128, 128)])
def test_record_sees_the_reference_spec_where_it_has_a_geometry(
        sq, sk, block_q, block_k):
    d = 64
    assert has_geometry(sq, sk, block_q=block_q, block_k=block_k)
    q = torch.zeros(1, sq, 1, d)
    kv = torch.zeros(1, sk, 1, d)
    with record() as launched:
        flash_attention(q, kv, kv, causal=False, block_q=block_q,
                        block_k=block_k)
    assert len(launched) == 1
    bq, bk = min(block_q, sq), min(block_k, sk)
    want = jax_capture(sq=sq, sk=sk, d=d, bq=bq, bk=bk, path="mirror")
    got = launched[0].to_grid_capture()
    assert tuple(got.grid) == tuple(want.grid)
    mine, theirs = walk(got), jax_walk(want)
    assert (mine.loads, mine.stores, mine.flops, mine.grid_steps) == (
        theirs.loads, theirs.stores, theirs.flops, theirs.grid_steps)
    assert mine.addresses.tobytes() == theirs.addresses.tobytes()


@pytest.mark.parametrize("sq,sk,block_q,block_k", [
    (200, 200, 128, 128), (300, 37, 128, 128), (37, 129, 128, 128),
    (384, 384, 256, 128), (1500, 1, 128, 128)])
def test_record_sees_no_spec_where_the_reference_has_none(sq, sk, block_q,
                                                          block_k):
    assert not has_geometry(sq, sk, block_q=block_q, block_k=block_k)
    q = torch.randn(1, sq, 2, 16)
    kv = torch.randn(1, sk, 1, 16)
    with record() as launched:
        with pytest.raises(ValueError, match="not multiples"):
            flash_attention(q, kv, kv, causal=True, block_q=block_q,
                            block_k=block_k)
    assert launched == []
    # the dispatcher computes them all, with a spec only on the
    # reference's kernel route (at its default tiles)
    with record() as launched:
        out = mha(q, kv, kv, causal=True)
    assert len(launched) == int(uses_kernel(sq, sk, 16))
    np.testing.assert_array_equal(out.numpy(),
                                  attention_ref(q, kv, kv).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_path_takes_a_launch_with_no_spec(dtype):
    # no reference geometry: the wrapper picks the kernel by dtype and D
    # alone, as it does with one
    assert kernel_path(dtype, 64) == kernel_path(dtype, 64, 128, 128)
    assert kernel_path(dtype, 320).endswith(
        "wide" if dtype == torch.float32 else "wide_sm90")


# --------------------------------------------------------------------------
# the f32 split plan on a ragged kv axis
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [64, 128, 192, 320])
@pytest.mark.parametrize("geo", [(1, 1, 1, 1), (1, 20, 1500, 1500),
                                 (1, 40, 2000, 2000), (1, 1, 37, 300),
                                 (2, 4, 200, 65), (1, 1, 100, 20481)])
def test_split_plan_covers_a_ragged_kv_axis(geo, d):
    b, h, sq, sk = geo
    dp = padded_head_dim(d)
    chunk = (wide_f32_plan(dp).kv_rows if dp > 256 else f32_tiles(dp)[1])
    per, n_splits = split_plan(b, h, sq, sk, n_sm=H100_SMS, d=dp)
    assert per % chunk == 0 and per >= 1
    ranges = [range(s, min(s + per, sk)) for s in range(0, sk, per)]
    assert len(ranges) == n_splits
    assert [i for r in ranges for i in r] == list(range(sk))
    assert all(len(r) >= 1 for r in ranges)
