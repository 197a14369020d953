"""Launch specs exactly where the reference launches its Pallas kernel, on
the CPU.

- The reference's dispatchers ``mha``, ``paged_decode`` and ``gather``
  (and the scans' and MoE's) run their kernel only on their kernel route;
  elsewhere their oracle launches nothing.  For every call of the probe
  table, ``record()`` around the port's dispatcher sees as many specs as
  ``jax.make_jaxpr`` of the reference's shows ``pallas_call``s, and both
  compute the same values.
- The kernel-level entries (``flash_attention``,
  ``paged_decode_attention``, ``gather_rows``) always emit, and their specs
  walk byte-identical to the reference's ``path="mirror"`` capture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.capture.grid import walk as jax_walk
from repro.kernels.flash_attention import mha as jax_mha
from repro.kernels.moe_dispatch import dispatch as jax_dispatch
from repro.kernels.paged_kv_decode import paged_decode as jax_paged_decode
from repro.kernels.paged_kv_decode.capture import capture as jax_paged_capture
from repro.kernels.ssm_scan import chunked_scan as jax_chunked_scan
from repro.kernels.ssm_scan import ema_scan as jax_ema_scan
from repro.kernels.token_gather import gather as jax_gather
from repro.kernels.token_gather.capture import capture as jax_gather_capture
from repro_torch.capture.grid import walk
from repro_torch.capture.launch import record
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.kernels import paged_kv_decode as port_paged
from repro_torch.kernels import token_gather as port_gather
from repro_torch.kernels.moe_dispatch import dispatch
from repro_torch.kernels.ssm_scan import chunked_scan, ema_scan

F32 = dict(atol=2e-5, rtol=1e-4)


def pallas_calls(fn, *args) -> int:
    """``pallas_call``s in the jaxpr of the reference's ``fn(*args)``."""
    return str(jax.make_jaxpr(fn)(*args)).count("pallas_call")


def _arrays(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(fn_ref, fn_port, arrays, **kw):
    """(reference launches, port specs, reference values, port values)."""
    jx = [jnp.asarray(a) for a in arrays]
    want = np.asarray(fn_ref(*jx, **kw))
    with record() as launched:
        got = fn_port(*(torch.from_numpy(a) for a in arrays), **kw)
    return (pallas_calls(lambda *a: fn_ref(*a, **kw), *jx), len(launched),
            want, got.numpy())


# queue 3 item 8's probe table, and its neighbours
MHA_PROBE = [  # (sq, sk, d)
    (64, 64, 64), (100, 37, 64), (128, 1, 64), (256, 256, 12),
    (128, 128, 64), (256, 128, 16), (128, 384, 8), (200, 128, 64)]


@pytest.mark.parametrize("sq,sk,d", MHA_PROBE)
def test_mha_specs_are_the_reference_launches(sq, sk, d):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = _arrays(rng, (1, sq, 2, d), (1, sk, 1, d), (1, sk, 1, d))
    want_n, got_n, want, got = _both(jax_mha, port_flash.mha, [q, k, v],
                                     causal=True)
    assert got_n == want_n
    assert want_n == int(sq % 128 == 0 and sk % 128 == 0 and d % 8 == 0)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("d", [64, 112, 128, 256])
def test_paged_decode_specs_are_the_reference_launches(d):
    rng = np.random.default_rng(d)
    q, kp, vp = _arrays(rng, (4, d), (12, 8, d), (12, 8, d))
    pt = rng.choice(12, 5, replace=False).astype(np.int32)
    want_n, got_n, want, got = _both(jax_paged_decode,
                                     port_paged.paged_decode,
                                     [q, kp, vp, pt])
    assert got_n == want_n == int(d % 128 == 0)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("d", [3, 64, 128, 384])
def test_gather_specs_are_the_reference_launches(d):
    rng = np.random.default_rng(d)
    (table,) = _arrays(rng, (40, d))
    idx = rng.integers(0, 40, 17).astype(np.int32)
    want_n, got_n, want, got = _both(jax_gather, port_gather.gather,
                                     [table, idx])
    assert got_n == want_n == int(d % 128 == 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t,d,chunk", [(256, 128, 128), (200, 128, 128),
                                       (256, 96, 128), (128, 256, 64)])
def test_scan_specs_are_the_reference_launches(t, d, chunk):
    rng = np.random.default_rng(t + d)
    x, g = _arrays(rng, (t, d), (t, d))
    dt = rng.uniform(0.5, 0.99, (t, d)).astype(np.float32)
    b, c = (a / 4 for a in _arrays(rng, (t, 16), (t, 16)))
    want_n, got_n, want, got = _both(jax_ema_scan, ema_scan, [x, dt, g],
                                     chunk=chunk)
    assert got_n == want_n == int(d % 128 == 0 and t % chunk == 0)
    np.testing.assert_allclose(got, want, **F32)
    want_n, got_n, want, got = _both(jax_chunked_scan, chunked_scan,
                                     [x, dt, b, c], chunk=chunk)
    assert got_n == want_n == int(d % 128 == 0 and t % chunk == 0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d,f", [(128, 128), (40, 24), (128, 96), (256, 3)])
def test_dispatch_specs_are_the_reference_launches(d, f):
    rng = np.random.default_rng(d + f)
    x, w = _arrays(rng, (24, d), (3, d, f))
    w /= np.sqrt(d)
    eid = rng.integers(0, 3, 24).astype(np.int32)
    want_n, got_n, want, got = _both(jax_dispatch, dispatch, [x, w, eid])
    assert got_n == want_n == int(d % 128 == 0 and f % 128 == 0)
    np.testing.assert_allclose(got, want, **F32)


# --------------------------------------------------------------------------
# the kernel-level entries: always a spec, the reference's mirror geometry
# --------------------------------------------------------------------------
def _same_walk(got_spec, want_capture) -> None:
    mine, theirs = walk(got_spec.to_grid_capture()), jax_walk(want_capture)
    assert (mine.loads, mine.stores, mine.flops, mine.grid_steps) == (
        theirs.loads, theirs.stores, theirs.flops, theirs.grid_steps)
    assert mine.addresses.tobytes() == theirs.addresses.tobytes()


@pytest.mark.parametrize("sq,sk,d", [(64, 64, 64), (100, 100, 12),
                                     (128, 1, 64)])
def test_flash_attention_always_emits(sq, sk, d):
    q = torch.zeros(1, sq, 1, d)
    kv = torch.zeros(1, sk, 1, d)
    with record() as launched:
        port_flash.flash_attention(q, kv, kv, causal=False, block_q=sq,
                                   block_k=sk)
    assert len(launched) == 1 and launched[0].grid == (1, 1, 1)


@pytest.mark.parametrize("d,n_active", [(128, 7), (256, 3)])
def test_paged_decode_attention_walks_the_reference_mirror(d, n_active):
    rng = np.random.default_rng(d)
    n_pages, page, h = 16, 8, 2
    pt = rng.choice(n_pages, n_active, replace=False)
    with record() as launched:
        port_paged.paged_decode_attention(
            torch.zeros(h, d), torch.zeros(n_pages, page, d),
            torch.zeros(n_pages, page, d), torch.from_numpy(pt))
    assert len(launched) == 1
    _same_walk(launched[0], jax_paged_capture(
        n_pages=n_pages, page=page, d=d, h=h, n_active=n_active,
        page_table=pt, path="mirror"))


@pytest.mark.parametrize("n_rows,d,m", [(64, 128, 9), (300, 256, 33)])
def test_gather_rows_walks_the_reference_mirror(n_rows, d, m):
    want = jax_gather_capture(n_rows, d, m, rng=np.random.default_rng(3),
                              path="mirror")
    idx = np.random.default_rng(3).integers(0, n_rows, size=m,
                                            dtype=np.int64)
    with record() as launched:
        port_gather.gather_rows(torch.zeros(n_rows, d),
                                torch.from_numpy(idx))
    assert len(launched) == 1
    _same_walk(launched[0], want)


def test_kernel_level_entries_emit_at_every_width():
    """Below the dispatchers' route the kernel-level entries still emit,
    as the reference's kernel-level functions launch at any width."""
    with record() as launched:
        port_paged.paged_decode_attention(
            torch.zeros(2, 64), torch.zeros(4, 8, 64), torch.zeros(4, 8, 64),
            torch.tensor([1, 3]))
        port_gather.gather_rows(torch.zeros(5, 3), torch.tensor([4, 0]))
    assert [s.name for s in launched] == ["paged_kv_decode", "token_gather"]
