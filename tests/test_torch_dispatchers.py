"""The reference's public dispatchers ``ssm_scan.ops.ema_scan`` /
``chunked_scan`` and ``moe_dispatch.ops.dispatch`` and their counterparts
in the port, on the CPU.

Each is held to the reference's at shapes the reference routes to its
Pallas kernel (run in interpret mode) and at shapes it routes to its
oracle, at the f32 tolerance (atol 2e-5, rtol 1e-4); ``record()`` sees
the reference's launch spec on the kernel route and none on the oracle
route, which launches no Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_dispatch import dispatch as jax_dispatch
from repro.kernels.ssm_scan import chunked_scan as jax_chunked_scan
from repro.kernels.ssm_scan import ema_scan as jax_ema_scan
from repro_torch.capture.launch import record
from repro_torch.kernels import moe_dispatch, ssm_scan
from repro_torch.kernels.moe_dispatch import dispatch
from repro_torch.kernels.ssm_scan import chunked_scan, ema_scan

F32 = dict(atol=2e-5, rtol=1e-4)


def _scan_inputs(t: int, d: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    dt = rng.uniform(0.5, 0.99, (t, d)).astype(np.float32)
    g = rng.standard_normal((t, d)).astype(np.float32)
    b = (rng.standard_normal((t, n)) / np.sqrt(n)).astype(np.float32)
    c = (rng.standard_normal((t, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, g, b, c


# (t, d, chunk, routed to the reference's kernel)
SCAN_SHAPES = [(256, 128, 128, True), (128, 256, 64, True),
               (200, 128, 128, False), (256, 64, 128, False),
               (37, 96, 16, False)]


@pytest.mark.parametrize("t,d,chunk,kernel", SCAN_SHAPES)
def test_ema_scan_matches_reference(t, d, chunk, kernel):
    x, dt, g, _, _ = _scan_inputs(t, d, 16, t + d)
    want = np.asarray(jax_ema_scan(jnp.asarray(x), jnp.asarray(dt),
                                   jnp.asarray(g), chunk=chunk))
    with record() as launched:
        got = ema_scan(*(torch.from_numpy(a) for a in (x, dt, g)),
                       chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert [s.name for s in launched] == (["ssm_ema"] if kernel else [])
    if kernel:
        assert launched[0].grid == (t // chunk,)


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("t,d,chunk,kernel", SCAN_SHAPES)
def test_chunked_scan_matches_reference(t, d, chunk, kernel, n):
    x, dt, _, b, c = _scan_inputs(t, d, n, t + d + n)
    want = np.asarray(jax_chunked_scan(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(b), jnp.asarray(c),
        chunk=chunk))
    with record() as launched:
        got = chunked_scan(*(torch.from_numpy(a) for a in (x, dt, b, c)),
                           chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert [s.name for s in launched] == (["ssm_expand"] if kernel else [])


# (t, d, f, experts, routed to the reference's kernel)
MOE_SHAPES = [(64, 128, 128, 4, True), (32, 256, 128, 8, True),
              (64, 64, 128, 4, False), (48, 128, 96, 3, False),
              (16, 40, 24, 2, False)]


@pytest.mark.parametrize("t,d,f,n_exp,kernel", MOE_SHAPES)
def test_dispatch_matches_reference(t, d, f, n_exp, kernel):
    rng = np.random.default_rng(t + d + f)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((n_exp, d, f)) / np.sqrt(d)).astype(np.float32)
    eid = rng.integers(0, n_exp, t).astype(np.int32)
    want = np.asarray(jax_dispatch(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(eid)))
    with record() as launched:
        got = dispatch(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(eid))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert [s.name for s in launched] == (["moe_dispatch"] if kernel
                                          else [])


def test_dispatchers_are_exported_as_the_reference_exports_them():
    assert ssm_scan.ema_scan is ssm_scan.ops.ema_scan
    assert ssm_scan.chunked_scan is ssm_scan.ops.chunked_scan
    assert moe_dispatch.dispatch is moe_dispatch.ops.dispatch
    for name in ("ema_scan", "chunked_scan"):
        assert name in ssm_scan.ops.__all__
    assert "dispatch" in moe_dispatch.ops.__all__


@pytest.mark.cuda
def test_card_raises_naming_roadmap_outside_the_kernels():
    """The scans and MoE take float16 and strided views on the card, held
    against their plain versions (f32 on the same inputs) within one float16
    ulp of the largest magnitude, each view read through one counted copy;
    what still raises names ROADMAP.md: float16 in flash and paged decode,
    float64 anywhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from repro_torch.kernels.flash_attention import mha
    from repro_torch.kernels.moe_dispatch import moe_dispatch_ref
    from repro_torch.kernels.paged_kv_decode import paged_decode
    from repro_torch.kernels.ssm_scan import ssm_chunked_ref, ssm_ema_ref
    from repro_torch.kernels.ssm_scan.kernel import (ssm_chunked_cuda,
                                                     ssm_ema_cuda)

    def held(got, want):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -10 * want.float().abs().max().item()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x32 = torch.randn(64, 96, generator=gen, device=dev)
    dt32 = 0.95 + 0.049 * torch.rand(64, 96, generator=gen, device=dev)
    b32 = torch.randn(64, 24, generator=gen, device=dev) / 24 ** 0.5
    x16, dt16, b16 = x32.half(), dt32.half(), b32.half()
    held(ema_scan(x16, dt16, x16),
         ssm_ema_ref(x16.float(), dt16.float(), x16.float()))
    held(chunked_scan(x16, dt16, b16, b16),
         ssm_chunked_ref(x16.float(), dt16.float(), b16.float(),
                         b16.float()))
    xs = x32.t().contiguous().t()               # a strided view
    copies = ssm_ema_cuda.copies, ssm_chunked_cuda.copies
    held(ema_scan(xs, dt32, xs), ssm_ema_ref(x32, dt32, x32))
    held(chunked_scan(xs, dt32, b32, b32),
         ssm_chunked_ref(x32, dt32, b32, b32))
    assert (ssm_ema_cuda.copies - copies[0],
            ssm_chunked_cuda.copies - copies[1]) == (2, 1)
    w16 = (torch.randn(2, 96, 24, generator=gen, device=dev) / 10).half()
    eid = torch.randint(0, 2, (64,), generator=gen, device=dev)
    held(dispatch(x16, w16, eid),
         moe_dispatch_ref(x16.float(), w16.float(), eid))
    held(dispatch(xs, w16.float(), eid),
         moe_dispatch_ref(x32, w16.float(), eid))
    q = torch.zeros(1, 128, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        mha(q, q, q, causal=True)
    pages = torch.zeros(4, 16, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        paged_decode(q[0, 0], pages, pages,
                     torch.zeros(2, dtype=torch.int32, device=dev))
    x64 = x32.double()
    with pytest.raises(ValueError, match="ROADMAP.md"):
        ema_scan(x64, x64, x64)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        dispatch(x64, w16.double(), eid)
