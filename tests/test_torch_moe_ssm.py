"""The port's MoE dispatch and SSM scan entry points on the CPU (their
plain PyTorch versions) against the reference Pallas kernels in interpret
mode, on the same seeded numpy inputs, at the cases and tolerances of
``tests/test_kernels.py``: MoE f32 atol 2e-5 / rtol 1e-4, the EMA scan
1e-3, the state-expanded scan 2e-3 (the reference kernels' closed forms
divide by the running decay product; the plain versions run the direct
recurrence), bf16 2e-2.  Also the launch specs these entry points record:
the reference's grids, blocks and two-index MoE operands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.capture.grid import walk as jax_walk
from repro.kernels.moe_dispatch import capture as jax_moe_capture
from repro.kernels.moe_dispatch import moe_dispatch as jax_moe
from repro.kernels.moe_dispatch import moe_dispatch_ref as jax_moe_ref
from repro.kernels.moe_dispatch import moe_dispatch_sorted as jax_moe_sorted
from repro.kernels.ssm_scan import capture as jax_ssm_capture
from repro.kernels.ssm_scan import ssm_chunked_ref as jax_chunked_ref
from repro.kernels.ssm_scan import ssm_chunked_scan as jax_chunked
from repro.kernels.ssm_scan import ssm_ema_ref as jax_ema_ref
from repro.kernels.ssm_scan import ssm_ema_scan as jax_ema
from repro_torch.capture.grid import walk
from repro_torch.capture.launch import record
from repro_torch.kernels import launch_counts
from repro_torch.kernels.moe_dispatch import (moe_dispatch,
                                              moe_dispatch_ref,
                                              moe_dispatch_sorted)
from repro_torch.kernels.moe_dispatch import capture as moe_capture
from repro_torch.kernels.ssm_scan import (ssm_chunked_ref, ssm_chunked_scan,
                                          ssm_ema_ref, ssm_ema_scan)
from repro_torch.kernels.ssm_scan import capture as ssm_capture
from repro_torch.kernels.ssm_scan.ops import launch_spec as ssm_spec
from repro_torch.kernels.ssm_scan.ops import scan_flops

MOE_TOL = dict(atol=2e-5, rtol=1e-4)
EMA_TOL = dict(atol=1e-3, rtol=1e-3)
CHUNKED_TOL = dict(atol=2e-3, rtol=2e-3)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _pair(x: np.ndarray, dtype: str = "float32"):
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
# MoE dispatch
# --------------------------------------------------------------------------
MOE_CASES = [
    # (T, d, f, E)
    (32, 128, 128, 4),
    (64, 128, 256, 16),
    (16, 256, 128, 2),
    (8, 128, 128, 8),      # more experts than tokens: some never hit
]


def _moe_inputs(case, dtype="float32"):
    t, d, f, e = case
    rng = np.random.default_rng(t * 131 + e)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    eids = rng.integers(0, e, size=t).astype(np.int32)
    return _pair(x, dtype), _pair(w, dtype), eids


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_dispatch_matches_reference(case):
    (jx, tx), (jw, tw), eids = _moe_inputs(case)
    want = jax_moe(jx, jw, jnp.asarray(eids), interpret=True)
    got = moe_dispatch(tx, tw, torch.from_numpy(eids))
    assert got.shape == (case[0], case[2]) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)
    np.testing.assert_allclose(
        _np(moe_dispatch_ref(tx, tw, torch.from_numpy(eids))),
        _np(jax_moe_ref(jx, jw, jnp.asarray(eids))), **MOE_TOL)


def test_moe_dispatch_single_expert_is_dense_gemm():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    w = (rng.standard_normal((1, 128, 128)) / np.sqrt(128)).astype(np.float32)
    got = moe_dispatch(torch.from_numpy(x), torch.from_numpy(w),
                       torch.zeros(16, dtype=torch.int32))
    np.testing.assert_allclose(_np(got), x @ w[0], **MOE_TOL)
    want = jax_moe(jnp.asarray(x), jnp.asarray(w), jnp.zeros(16, jnp.int32),
                   interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)


def test_moe_dispatch_sorted_matches_reference():
    """The sorted entry with an explicit token order, as the capture hooks
    and the kernel take it."""
    (jx, tx), (jw, tw), eids = _moe_inputs((64, 128, 128, 8))
    rng = np.random.default_rng(3)
    tok = rng.permutation(64).astype(np.int32)
    eid = np.sort(eids).astype(np.int32)
    want = jax_moe_sorted(jx, jw, jnp.asarray(tok), jnp.asarray(eid),
                          interpret=True)
    got = moe_dispatch_sorted(tx, tw, torch.from_numpy(tok),
                              torch.from_numpy(eid))
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)


def test_moe_dispatch_matches_reference_bf16():
    (jx, tx), (jw, tw), eids = _moe_inputs((32, 128, 128, 4), "bfloat16")
    want = jax_moe(jx, jw, jnp.asarray(eids), interpret=True)
    got = moe_dispatch(tx, tw, torch.from_numpy(eids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("which", ["token", "expert"])
def test_moe_out_of_range_index_raises(which):
    """A token or expert id past its range raises on the CPU; on the card
    the kernel traps instead (chip_smoke.py checks that)."""
    x, w = torch.zeros(4, 128), torch.zeros(2, 128, 128)
    tok = torch.tensor([0, 1, 2, 4 if which == "token" else 3])
    eid = torch.tensor([0, 0, 1, 2 if which == "expert" else 1])
    with pytest.raises(IndexError):
        moe_dispatch_sorted(x, w, tok, eid)
    with pytest.raises(IndexError):
        moe_dispatch_sorted(x, w, tok.flip(0) - 1, eid.flip(0) - 1)


@pytest.mark.parametrize("tok", [[0, 1, 1, 3], [2, 2, 2, 2]])
def test_moe_token_order_with_a_repeat_raises(tok):
    """A token order that is not a permutation would leave rows of y
    unwritten; it raises on the CPU, and the kernel's pre-pass traps on the
    card (chip_smoke.py checks that)."""
    x, w = torch.zeros(4, 128), torch.zeros(2, 128, 128)
    eid = torch.tensor([0, 0, 1, 1])
    with pytest.raises(ValueError, match="permutation"):
        moe_dispatch_sorted(x, w, torch.tensor(tok), eid)


def test_moe_spec_carries_both_index_vectors():
    """tok then eid, read once; x and y steered by tok, w by eid."""
    x, w = torch.zeros(4, 128), torch.zeros(3, 128, 256)
    tok = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    eid = torch.tensor([0, 0, 2, 2], dtype=torch.int32)
    with record() as launched:
        moe_dispatch_sorted(x, w, tok, eid)
    (spec,) = launched
    assert spec.grid == (4,)
    assert [op.name for op in spec.operands] == ["tok", "eid", "x", "w", "y"]
    assert [op.role for op in spec.operands[:2]] == ["index", "index"]
    assert len(spec.index) == 2
    assert (spec.operand("x").block_shape, spec.operand("w").block_shape,
            spec.operand("y").block_shape) == ((1, 128), (1, 128, 256),
                                               (1, 256))
    cap = spec.to_grid_capture()
    steps = [op.index_map(i) for op in cap.operands[2:] for i in range(4)]
    assert steps == [(2, 0), (0, 0), (3, 0), (1, 0),
                     (0, 0, 0), (0, 0, 0), (2, 0, 0), (2, 0, 0),
                     (2, 0), (0, 0), (3, 0), (1, 0)]
    res = walk(cap)
    # w is fetched once per expert run (revisiting): 2 runs, not 4 steps
    tile_w = 128 * 256 // 2
    assert res.loads == 2 * 2 + 4 * 64 + 2 * tile_w
    assert res.stores == 4 * 128


def test_moe_capture_expert_ids_draw_order():
    """Given expert_ids, the hook still draws the token order from rng, so
    a shared rng moves on exactly as the reference's does."""
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    ids = np.array([3, 1, 1, 0])
    got = walk(moe_capture.capture(n_tokens=4, d=128, f=128, n_experts=4,
                                   rng=rng_a, expert_ids=ids, device="cpu"))
    want = jax_walk(jax_moe_capture.capture(
        n_tokens=4, d=128, f=128, n_experts=4, rng=rng_b, expert_ids=ids,
        path="mirror"))
    assert got.addresses.tobytes() == want.addresses.tobytes()
    assert rng_a.integers(1 << 30) == rng_b.integers(1 << 30)


# --------------------------------------------------------------------------
# SSM scans
# --------------------------------------------------------------------------
def _ssm_inputs(t, d, n=None, dtype="float32", seed=0):
    rng = np.random.default_rng(seed + t + d + (n or 0))
    x = rng.standard_normal((t, d)).astype(np.float32)
    # dt in (0.95, 0.999): the reference's closed form divides by the
    # running decay product, so the comparison stays in its precision regime
    dt = rng.uniform(0.95, 0.999, (t, d)).astype(np.float32)
    if n is None:
        g = rng.standard_normal((t, d)).astype(np.float32)
        return _pair(x, dtype), _pair(dt, dtype), _pair(g, dtype)
    b = (rng.standard_normal((t, n)) / np.sqrt(n)).astype(np.float32)
    c = rng.standard_normal((t, n)).astype(np.float32)
    return (_pair(x, dtype), _pair(dt, dtype), _pair(b, dtype),
            _pair(c, dtype))


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssm_ema_matches_reference(chunk):
    (jx, tx), (jdt, tdt), (jg, tg) = _ssm_inputs(256, 128)
    want = jax_ema(jx, jdt, jg, chunk=chunk, interpret=True)
    got = ssm_ema_scan(tx, tdt, tg, chunk=chunk)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **EMA_TOL)
    np.testing.assert_allclose(_np(ssm_ema_ref(tx, tdt, tg)),
                               _np(jax_ema_ref(jx, jdt, jg)), **EMA_TOL)


def test_ssm_ema_chunk_invariance():
    """The chunk is launch geometry only: the port at chunk 32 equals the
    reference kernel at chunk 256."""
    (jx, tx), (jdt, tdt), (jg, tg) = _ssm_inputs(256, 128)
    want = jax_ema(jx, jdt, jg, chunk=256, interpret=True)
    got = ssm_ema_scan(tx, tdt, tg, chunk=32)
    np.testing.assert_allclose(_np(got), _np(want), **EMA_TOL)
    np.testing.assert_array_equal(_np(got),
                                  _np(ssm_ema_scan(tx, tdt, tg, chunk=256)))


def test_ssm_state_carries_across_chunks():
    """With dt == 1 and g == 1 the EMA scan is a running sum."""
    x = np.random.default_rng(5).standard_normal((256, 128)).astype(
        np.float32)
    ones = torch.ones(256, 128)
    got = ssm_ema_scan(torch.from_numpy(x), ones, ones, chunk=64)
    np.testing.assert_allclose(_np(got)[-1], x.sum(axis=0), atol=1e-3,
                               rtol=1e-4)
    want = jax_ema(jnp.asarray(x), jnp.ones((256, 128)),
                   jnp.ones((256, 128)), chunk=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **EMA_TOL)


@pytest.mark.parametrize("case", [(256, 128, 128, 64), (128, 256, 128, 32),
                                  (64, 128, 256, 64)])
def test_ssm_chunked_matches_reference(case):
    t, d, n, chunk = case
    (jx, tx), (jdt, tdt), (jb, tb), (jc, tc) = _ssm_inputs(t, d, n)
    want = jax_chunked(jx, jdt, jb, jc, chunk=chunk, interpret=True)
    got = ssm_chunked_scan(tx, tdt, tb, tc, chunk=chunk)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **CHUNKED_TOL)
    np.testing.assert_allclose(_np(ssm_chunked_ref(tx, tdt, tb, tc)),
                               _np(jax_chunked_ref(jx, jdt, jb, jc)),
                               **CHUNKED_TOL)


@pytest.mark.parametrize("op", ["ema", "expand"])
def test_ssm_scans_match_reference_bf16(op):
    if op == "ema":
        (jx, tx), (jdt, tdt), (jg, tg) = _ssm_inputs(128, 128,
                                                     dtype="bfloat16")
        want = jax_ema(jx, jdt, jg, chunk=64, interpret=True)
        got = ssm_ema_scan(tx, tdt, tg, chunk=64)
    else:
        (jx, tx), (jdt, tdt), (jb, tb), (jc, tc) = _ssm_inputs(
            128, 128, 64, dtype="bfloat16")
        want = jax_chunked(jx, jdt, jb, jc, chunk=64, interpret=True)
        got = ssm_chunked_scan(tx, tdt, tb, tc, chunk=64)
    assert got.dtype == torch.bfloat16
    scale = np.abs(_np(want)).max()
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2,
                               atol=2e-2 * scale)


@pytest.mark.parametrize("op", ["ema", "expand"])
def test_ssm_spec_is_the_reference_chunk_grid(op):
    spec = ssm_spec(op, 512, 256, 128, 64, torch.float32)
    assert spec.grid == (8,)
    assert spec.name == f"ssm_{op}"
    assert spec.index == ()
    widths = {op.name: op.block_shape for op in spec.operands}
    if op == "ema":
        assert widths == {"x": (64, 256), "dt": (64, 256), "g": (64, 256),
                          "y": (64, 256)}
    else:
        assert widths == {"x": (64, 256), "dt": (64, 256), "b": (64, 128),
                          "c": (64, 128), "y": (64, 256)}
    assert spec.flops == scan_flops(op, seq_len=512, d=256, n=128, chunk=64)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm_spec(op, 500, 256, 128, 64, torch.float32)


@pytest.mark.parametrize("cores", [1, 4, 16])
def test_ssm_capture_walks_the_reference_stream(cores):
    for op, n in (("ema", 0), ("expand", 128)):
        got = walk(ssm_capture.capture(op, seq_len=1024, d=128, n=n,
                                       chunk=128, cores=cores, device="cpu"))
        want = jax_walk(jax_ssm_capture.capture(
            op, seq_len=1024, d=128, n=n, chunk=128, cores=cores,
            path="mirror"))
        assert got.addresses.tobytes() == want.addresses.tobytes()
        assert got.flops == want.flops


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain versions: no launch counter moves."""
    before = launch_counts()
    moe_dispatch(torch.zeros(4, 128), torch.zeros(2, 128, 128),
                 torch.tensor([1, 0, 1, 0]))
    ssm_ema_scan(torch.zeros(128, 128), torch.ones(128, 128),
                 torch.ones(128, 128))
    ssm_chunked_scan(torch.zeros(128, 128), torch.ones(128, 128),
                     torch.zeros(128, 16), torch.zeros(128, 16))
    assert launch_counts() == before
