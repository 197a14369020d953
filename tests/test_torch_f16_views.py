"""Float16 and strided, expanded or unaligned inputs in the port's kernels.

On the CPU, the same numpy-seeded inputs go through the reference's
kernels (interpret mode, or the oracle its dispatcher picks off the
kernel route) and through the port's entry points in float16: STREAM's
four ops, the gather (bit for bit), both scans (D off 128, N 1, 24 and
96) and MoE dispatch (D 3, F 5 among them).  The tolerance is one float16
ulp of the reference's largest magnitude, |port - ref| <= 2^-10 max|ref|,
with infinities required at the same places.

The port's entry points take views (a transposed, sliced, expanded or
offset tensor) and give what the contiguous copy gives.  Each ``*_cuda``
wrapper is driven with its launch replaced by a recorder (the kernels
build only on the card): it hands its kernel the view itself where it is
dense, else one dense, 16-byte aligned copy counted on ``copies``; the
gather reads a row-strided table where it lies; STREAM's in-place ``out``
and flash and paged decode in float16 still raise, naming ROADMAP.md.
The element-type table matches ``csrc/common.cuh``, and the plans at
2-byte elements are bf16's.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_dispatch import dispatch as jax_dispatch
from repro.kernels.ssm_scan import chunked_scan as jax_chunked
from repro.kernels.ssm_scan import ema_scan as jax_ema
from repro.kernels.stream import (stream_add, stream_copy, stream_scale,
                                  stream_triad)
from repro.kernels.token_gather import gather_rows as jax_gather
from repro_torch.kernels import _build, copy_counts, reset_launch_counts
from repro_torch.kernels import flash_attention as flash_pkg
from repro_torch.kernels import moe_dispatch as moe_pkg
from repro_torch.kernels import paged_kv_decode as paged_pkg
from repro_torch.kernels import ssm_scan as scan_pkg
from repro_torch.kernels import stream as stream_pkg
from repro_torch.kernels import token_gather as gather_pkg
from repro_torch.kernels import window_scan as window_pkg
from repro_torch.kernels.moe_dispatch import dispatch
from repro_torch.kernels.moe_dispatch.plan import (BLOCKS_PER_SM, BN,
                                                   launch_shape)
from repro_torch.kernels.ssm_scan import chunked_scan, ema_scan
from repro_torch.kernels.ssm_scan.plan import copy_piece, ema_plan, scan_plan
from repro_torch.kernels.stream import ops as stream_ops
from repro_torch.kernels.token_gather import gather
from repro_torch.kernels.token_gather.kernel import row_piece, row_view

ULP16 = 2.0 ** -10   # one float16 ulp at 1, relative to max|ref|


def assert_within_ulp(got: torch.Tensor, want) -> None:
    """|got - want| <= 2^-10 max|want| where want is finite; infinities of
    the same sign at the same places."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = ~inf
    scale = np.abs(want[fin]).max(initial=0.0)
    err = np.abs(got[fin] - want[fin]).max(initial=0.0)
    assert err <= ULP16 * scale, (err, scale)


def _f16(x: np.ndarray):
    """The same float16 values as a jax array and a CPU torch tensor."""
    h = x.astype(np.float16)
    return jnp.asarray(h), torch.from_numpy(h)


def _scan_inputs(t: int, d: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    dt = rng.uniform(0.95, 0.999, (t, d)).astype(np.float32)
    g = rng.standard_normal((t, d)).astype(np.float32)
    b = (rng.standard_normal((t, n)) / np.sqrt(n)).astype(np.float32)
    c = rng.standard_normal((t, n)).astype(np.float32)
    return x, dt, g, b, c


# --------------------------------------------------------------------------
# float16 against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["copy", "scale", "add", "triad"])
def test_stream_f16_matches_reference(op):
    rng = np.random.default_rng(len(op))
    n = 512 * 128
    ja, ta = _f16(rng.standard_normal(n).astype(np.float32))
    jb, tb = _f16(rng.standard_normal(n).astype(np.float32))
    want, got = {
        "copy": lambda: (stream_copy(ja, interpret=True),
                         stream_ops.stream_copy(ta)),
        "scale": lambda: (stream_scale(ja, 3.0, interpret=True),
                          stream_ops.stream_scale(ta, 3.0)),
        "add": lambda: (stream_add(ja, jb, interpret=True),
                        stream_ops.stream_add(ta, tb)),
        "triad": lambda: (stream_triad(ja, jb, 3.0, interpret=True),
                          stream_ops.stream_triad(ta, tb, 3.0)),
    }[op]()
    assert got.dtype == torch.float16 and got.shape == ta.shape
    assert_within_ulp(got, want)


@pytest.mark.parametrize("d", [3, 64, 100, 128])
def test_gather_f16_is_the_reference_bit_for_bit(d):
    rng = np.random.default_rng(d)
    jt, tt = _f16(rng.standard_normal((50, d)).astype(np.float32))
    idx = rng.integers(0, 50, 37).astype(np.int32)
    want = np.asarray(jax_gather(jt, jnp.asarray(idx), interpret=True))
    got = gather(tt, torch.from_numpy(idx))
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy().view(np.uint16),
                                  want.view(np.uint16))


# (T, D, chunk): the reference's kernel route, then D off 128 (its oracle)
SCAN_SHAPES = [(256, 128, 128), (200, 96, 40), (64, 3, 64), (96, 200, 32)]


@pytest.mark.parametrize("t,d,chunk", SCAN_SHAPES)
def test_ema_scan_f16_matches_reference(t, d, chunk):
    x, dt, g, _, _ = _scan_inputs(t, d, 1, t + d)
    (jx, tx), (jdt, tdt), (jg, tg) = _f16(x), _f16(dt), _f16(g)
    want = jax_ema(jx, jdt, jg, chunk=chunk)
    got = ema_scan(tx, tdt, tg, chunk=chunk)
    assert got.dtype == torch.float16
    assert_within_ulp(got, want)


@pytest.mark.parametrize("n", [1, 24, 96])
@pytest.mark.parametrize("t,d,chunk", SCAN_SHAPES)
def test_chunked_scan_f16_matches_reference(t, d, chunk, n):
    x, dt, _, b, c = _scan_inputs(t, d, n, t + d + n)
    (jx, tx), (jdt, tdt) = _f16(x), _f16(dt)
    (jb, tb), (jc, tc) = _f16(b), _f16(c)
    want = jax_chunked(jx, jdt, jb, jc, chunk=chunk)
    got = chunked_scan(tx, tdt, tb, tc, chunk=chunk)
    assert got.dtype == torch.float16
    assert_within_ulp(got, want)


# (T, D, F, experts): the reference's kernel route, then its oracle's
MOE_SHAPES = [(64, 128, 128, 4), (48, 40, 24, 3), (32, 3, 5, 2),
              (40, 100, 200, 4)]


@pytest.mark.parametrize("t,d,f,n_exp", MOE_SHAPES)
def test_moe_dispatch_f16_matches_reference(t, d, f, n_exp):
    rng = np.random.default_rng(t + d + f)
    jx, tx = _f16(rng.standard_normal((t, d)).astype(np.float32))
    jw, tw = _f16((rng.standard_normal((n_exp, d, f))
                   / np.sqrt(d)).astype(np.float32))
    eid = rng.integers(0, n_exp, t).astype(np.int32)
    want = jax_dispatch(jx, jw, jnp.asarray(eid))
    got = dispatch(tx, tw, torch.from_numpy(eid))
    assert got.dtype == torch.float16
    assert_within_ulp(got, want)


def test_the_check_wants_infinities_at_the_same_places():
    want = np.array([np.inf, 1.0, -np.inf], dtype=np.float32)
    assert_within_ulp(torch.tensor([np.inf, 1.0, -np.inf]), want)
    with pytest.raises(AssertionError):
        assert_within_ulp(torch.tensor([65504.0, 1.0, -np.inf]), want)
    with pytest.raises(AssertionError):
        assert_within_ulp(torch.tensor([np.inf, 1.01, -np.inf]), want)


# --------------------------------------------------------------------------
# views through the entry points (the plain versions here)
# --------------------------------------------------------------------------
def views(t: torch.Tensor) -> dict[str, torch.Tensor]:
    """Views equal to ``t`` [R, C]: transposed storage, a slice of a wider
    array, an expanded row (where every row is the first), and a
    contiguous view that starts one element off its storage."""
    wide = torch.zeros(t.shape[0], t.shape[1] + 5, dtype=t.dtype)
    wide[:, 2:2 + t.shape[1]] = t
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    flat[1:] = t.reshape(-1)
    out = {"transposed": t.t().contiguous().t(),
           "sliced": wide[:, 2:2 + t.shape[1]],
           "offset": flat[1:].view(t.shape)}
    for v in out.values():
        assert torch.equal(v, t)
    assert not out["transposed"].is_contiguous()
    assert not out["sliced"].is_contiguous()
    assert out["offset"].data_ptr() % 16
    return out


def row_expanded(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(t's first row expanded over t's rows, its contiguous copy)."""
    e = t[:1].expand(t.shape)
    return e, e.contiguous()


DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["transposed", "sliced", "offset",
                                  "expanded"])
def test_scans_take_views(kind, dtype):
    x, dt, g, b, c = (torch.from_numpy(a).to(dtype)
                      for a in _scan_inputs(64, 40, 24, 3))
    for i, base in enumerate((x, dt, g)):
        if kind == "expanded":
            view, dense = row_expanded(base)
        else:
            view, dense = views(base)[kind], base
        args = [x, dt, g]
        want_args = list(args)
        args[i], want_args[i] = view, dense
        assert torch.equal(ema_scan(*args, chunk=16),
                           ema_scan(*want_args, chunk=16))
    for i, base in enumerate((x, dt, b, c)):
        if kind == "expanded":
            view, dense = row_expanded(base)
        else:
            view, dense = views(base)[kind], base
        args = [x, dt, b, c]
        want_args = list(args)
        args[i], want_args[i] = view, dense
        assert torch.equal(chunked_scan(*args, chunk=16),
                           chunked_scan(*want_args, chunk=16))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["transposed", "sliced", "offset",
                                  "expanded"])
def test_gather_moe_and_stream_take_views(kind, dtype):
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((30, 24))).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 30, 17).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((40, 24))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((3, 24, 16)) / 5).to(dtype)
    eid = torch.from_numpy(rng.integers(0, 3, 40))
    a = torch.from_numpy(rng.standard_normal((512, 128))).to(dtype)
    bb = torch.from_numpy(rng.standard_normal((512, 128))).to(dtype)

    def pick(t):
        if kind == "expanded":
            return row_expanded(t)
        return views(t)[kind], t

    tv, td = pick(table)
    assert torch.equal(gather(tv, idx), gather(td, idx))
    xv, xd = pick(x)
    assert_within_ulp(dispatch(xv, w, eid), dispatch(xd, w, eid).float())
    wv = w.transpose(1, 2).contiguous().transpose(1, 2)
    assert_within_ulp(dispatch(x, wv, eid), dispatch(x, w, eid).float())
    av, ad = pick(a)
    assert torch.equal(stream_ops.stream_triad(av, bb, 3.0),
                       stream_ops.stream_triad(ad, bb, 3.0))
    assert torch.equal(stream_ops.stream_add(bb, av),
                       stream_ops.stream_add(bb, ad))


def test_flash_and_paged_take_views():
    from repro_torch.kernels.flash_attention import mha
    from repro_torch.kernels.paged_kv_decode import paged_decode

    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 2, 40, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 40, 16)).astype(
        np.float32))
    # [B, H, S, D] views handed over as [B, S, H, D]
    got = mha(q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2),
              causal=True)
    want = mha(*(t.transpose(1, 2).contiguous() for t in (q, k, k)),
               causal=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    qd = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    pages = torch.from_numpy(rng.standard_normal((6, 4, 16)).astype(
        np.float32))
    table = torch.tensor([4, 1, 3], dtype=torch.int32)
    pv = pages.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(paged_decode(qd, pv, pv, table),
                               paged_decode(qd, pages, pages, table),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the wrappers' dense copies (launches recorded, not run)
# --------------------------------------------------------------------------
class Recorder:
    """Stands in for a kernel's ctypes entry: records each call's
    arguments and reports success."""

    def __init__(self, ret=0):
        self.calls, self.ret = [], ret

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


@pytest.fixture
def on_card(monkeypatch):
    """Every wrapper believes its CPU tensors lie on a card, and each
    kernel entry (``_fn`` and the like) is a Recorder."""
    monkeypatch.setattr(_build, "on_card", lambda *t: True)
    monkeypatch.setattr(_build, "check", lambda name, err: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "sm_count", lambda t: 132)
    rec = {}
    for mod, names in ((stream_pkg.kernel, ["_fn"]),
                       (gather_pkg.kernel, ["_fn"]),
                       (flash_pkg.kernel, ["_fn"]),
                       (paged_pkg.kernel, ["_launch_fn", "_smem_fn"]),
                       (moe_pkg.kernel, ["_fn"]),
                       (scan_pkg.kernel, ["_ema_fn", "_chunked_fn"]),
                       (window_pkg.kernel, ["_fn"])):
        for name in names:
            r = rec[f"{mod.__name__.split('.')[-2]}.{name}"] = Recorder(
                1024 if name == "_smem_fn" else 0)
            monkeypatch.setattr(mod, name, lambda r=r: r)
    monkeypatch.setattr(window_pkg.kernel, "_resident", lambda *a: 2)
    reset_launch_counts()
    yield rec
    reset_launch_counts()


def test_dense_returns_the_tensor_or_one_aligned_copy():
    t = torch.arange(64, dtype=torch.float32).view(8, 8)
    assert _build.dense(t) is t
    assert _build.is_dense(t)

    class Owner:
        copies = 0

    for v in (t.t(), t[:, 1:5], t[:1].expand(8, 8),
              t.view(-1)[1:33].view(4, 8)):
        assert not _build.is_dense(v)
        c = _build.dense(v, Owner)
        assert c is not v and c.is_contiguous() and c.data_ptr() % 16 == 0
        assert torch.equal(c, v)
    assert Owner.copies == 4


def test_dtype_codes_are_common_cuh_s():
    src = (_build.CSRC / "common.cuh").read_text()
    enum = re.search(r"enum ReproDType \{([^}]*)\}", src).group(1)
    codes = {name.strip(): int(v) for name, v in
             (item.split("=") for item in enum.split(","))}
    want = {torch.float32: codes["REPRO_F32"],
            torch.bfloat16: codes["REPRO_BF16"],
            torch.float16: codes["REPRO_F16"]}
    assert _build.DTYPE_CODES == want
    assert len(codes) == len(_build.DTYPE_CODES)
    assert _build.dtype_code(torch.zeros(1, dtype=torch.float16)) == 2
    for bad in ([torch.zeros(1, dtype=torch.float64)],
                [torch.zeros(1), torch.zeros(1, dtype=torch.float16)]):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            _build.dtype_code(*bad)


@pytest.mark.parametrize("dtype", DTYPES)
def test_stream_wrapper_copies_views_and_refuses_a_strided_out(on_card,
                                                               dtype):
    a = torch.zeros(512, 128, dtype=dtype)
    spec = stream_ops.launch_spec("add", a.numel(), dtype)
    k = stream_pkg.kernel.stream_cuda
    k(spec, "add", a, a)
    assert k.copies == 0 and on_card["stream._fn"].calls[-1][2] == a.data_ptr()
    k(spec, "add", a.t().contiguous().t(), a)
    assert k.copies == 1 and k.launches == 2
    assert on_card["stream._fn"].calls[-1][1] == _build.DTYPE_CODES[dtype]
    flat = torch.zeros(a.numel() + 1, dtype=dtype)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        k(spec, "add", a, a, out=flat[1:].view(a.shape))
    with pytest.raises(ValueError, match="ROADMAP.md"):
        k(spec, "copy", a.double())
    assert k.launches == 2 and k.copies == 1


def test_gather_wrapper_reads_a_row_strided_table_where_it_lies(on_card):
    k = gather_pkg.kernel.gather_rows_cuda
    rec = on_card["token_gather._fn"]
    wide = torch.zeros(100, 131, dtype=torch.float16)
    table = wide[:, 3:103]                 # rows 262 bytes apart, 6 off
    idx = torch.zeros(9, dtype=torch.int32)
    spec = gather_pkg.ops.launch_spec(100, 100, idx, table.dtype)
    k(spec, table, idx)
    args = rec.calls[-1]
    assert k.copies == 0 and args[0] == table.data_ptr()
    assert args[5:7] == (200, 262)         # row bytes, row stride bytes
    assert row_piece(200, 262, table.data_ptr()) == 2
    k(spec, wide.t().contiguous().t()[:, 3:103], idx)   # columns apart
    assert k.copies == 1
    k(spec, table, torch.zeros(18, dtype=torch.int32)[::2])
    assert k.copies == 2 and k.launches == 3
    assert row_view(table) and not row_view(table.t())


@pytest.mark.parametrize("row_bytes,stride,address,want", [
    (512, 512, 0, 16), (512, 1024, 8, 8), (200, 262, 0, 2),
    (20472, 20480, 4096, 8), (10236, 10236, 2, 2), (12, 0, 4, 4),
    (3, 6, 0, 1), (64, 80, 16, 16), (64, 72, 0, 8)])
def test_gather_piece_divides_rows_stride_and_address(row_bytes, stride,
                                                      address, want):
    assert row_piece(row_bytes, stride, address) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_wrappers_copy_mamba_s_slices(on_card, dtype):
    t, d, n = 64, 96, 24
    xz = torch.zeros(t, 2 * d, dtype=dtype)
    x = xz[:, :d]                          # Mamba's x = xz[:, :d_inner]
    dense = torch.zeros(t, d, dtype=dtype)
    spec = scan_pkg.ops.launch_spec("ema", t, d, 0, t, dtype)
    ema = scan_pkg.kernel.ssm_ema_cuda
    ema(spec, dense, dense, dense)
    assert ema.copies == 0
    ema(spec, x, dense, x)
    assert ema.copies == 2 and ema.launches == 2
    args = on_card["ssm_scan._ema_fn"].calls[-1]
    assert args[0] == _build.DTYPE_CODES[dtype]
    assert args[1] not in (x.data_ptr(),) and args[2] == dense.data_ptr()
    bc = torch.zeros(t, n, dtype=dtype)
    spec = scan_pkg.ops.launch_spec("expand", t, d, n, t, dtype)
    chunked = scan_pkg.kernel.ssm_chunked_cuda
    chunked(spec, dense, dense, bc, bc.t().contiguous().t())
    assert chunked.copies == 1
    chunked(spec, x, x, bc, bc)
    assert chunked.copies == 3 and chunked.launches == 2
    assert copy_counts()["ssm_ema_scan"] == 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_wrapper_copies_views(on_card, dtype):
    t, d, f, e = 40, 24, 16, 3
    x = torch.zeros(t, d, dtype=dtype)
    w = torch.zeros(e, d, f, dtype=dtype)
    tok = torch.arange(t, dtype=torch.int32)
    eid = torch.zeros(t, dtype=torch.int32)
    spec = moe_pkg.ops.launch_spec(t, d, f, e, tok, eid, dtype)
    k = moe_pkg.kernel.moe_grouped_gemm
    k(spec, x, w, tok, eid)
    assert k.copies == 0
    flat = torch.zeros(x.numel() + 1, dtype=dtype)
    k(spec, flat[1:].view(t, d), w.transpose(1, 2).contiguous()
      .transpose(1, 2), torch.arange(2 * t, dtype=torch.int32)[::2], eid)
    assert k.copies == 3 and k.launches == 2
    args = on_card["moe_dispatch._fn"].calls[-1]
    assert args[0] == _build.DTYPE_CODES[dtype] and args[1] % 16 == 0
    with pytest.raises(ValueError, match="in place"):
        k(spec, x, w, tok, eid, out=torch.zeros(f, t, dtype=dtype).t())


def test_flash_and_paged_wrappers_copy_views_and_refuse_float16(on_card):
    k = flash_pkg.kernel.flash_attention_cuda
    q = torch.zeros(1, 2, 40, 64)          # [B, H, S, D]
    spec = flash_pkg.ops.launch_spec(1, 40, 40, 2, 2, 64, q.dtype)
    k(spec, q.transpose(1, 2), q.transpose(1, 2).contiguous(),
      q.transpose(1, 2), causal=True)
    assert k.copies == 2 and k.launches == 1
    h = q.transpose(1, 2).half()
    with pytest.raises(ValueError, match="ROADMAP.md"):
        k(spec, h, h, h, causal=True)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        k(None, h[:, :, :, :8], h[:, :, :, :8], h[:, :, :, :8], causal=True)
    assert k.copies == 2 and k.launches == 1
    p = paged_pkg.kernel.paged_decode_cuda
    qd = torch.zeros(2, 64)
    pages = torch.zeros(6, 4, 64)
    table = torch.tensor([4, 1, 3], dtype=torch.int32)
    spec = paged_pkg.ops.launch_spec(2, 64, 6, 4, table, qd.dtype)
    p(spec, qd, pages, pages, table)
    assert p.copies == 0
    p(spec, qd.t().contiguous().t(), pages, pages[:, :, :].transpose(1, 2)
      .contiguous().transpose(1, 2), torch.tensor([9, 4, 9, 1, 9, 3],
                                                  dtype=torch.int32)[1::2])
    assert p.copies == 3 and p.launches == 2
    with pytest.raises(ValueError, match="ROADMAP.md"):
        p(spec, qd.half(), pages.half(), pages.half(), table)
    assert p.copies == 3 and p.launches == 2


def test_window_wrapper_copies_views(on_card):
    k = window_pkg.kernel.window_count_cuda
    q = torch.zeros(64, dtype=torch.int32)
    rows = torch.zeros(3, 5, dtype=torch.int32)
    k(q, rows, 8)
    assert k.copies == 0
    k(torch.zeros(128, dtype=torch.int32)[::2], rows.t().contiguous().t(), 8)
    assert k.copies == 2 and k.launches == 2


# --------------------------------------------------------------------------
# the plans at 2-byte elements
# --------------------------------------------------------------------------
@pytest.mark.parametrize("t,d,n", [(4096, 7168, 64), (300, 100, 24),
                                   (300, 3, 384), (128, 256, 96)])
def test_scan_plans_at_two_byte_elements_are_bf16_s(t, d, n):
    size = torch.float16.itemsize
    assert size == torch.bfloat16.itemsize == 2
    assert scan_plan(t, d, n, size, n_sm=132) == scan_plan(
        t, d, n, torch.bfloat16.itemsize, n_sm=132)
    plan = ema_plan(t, d, size, n_sm=132)
    assert plan == ema_plan(t, d, torch.bfloat16.itemsize, n_sm=132)
    assert plan.piece == copy_piece(d, 2)
    assert plan.channels * size >= 16


@pytest.mark.parametrize("t,f", [(24576, 1408), (256, 5), (40, 128)])
def test_moe_plan_at_float16_is_bf16_s(t, f):
    assert BN[torch.float16] == BN[torch.bfloat16]
    assert BLOCKS_PER_SM[torch.float16] == BLOCKS_PER_SM[torch.bfloat16]
    assert launch_shape(torch.float16, t, f, n_sm=132) == launch_shape(
        torch.bfloat16, t, f, n_sm=132)
