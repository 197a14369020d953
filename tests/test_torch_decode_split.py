"""The paged decode kernel's split design on the CPU: the split plan
(``repro_torch.kernels.paged_kv_decode.plan``) and the arithmetic of
``paged_split`` + ``paged_combine`` (``csrc/paged_kv_decode.cu``)
emulated in float32.

Each split of consecutive table entries runs the reference's online
softmax (running max from -1e30) over its own pages and keeps m, l and the
unnormalized acc; the combine takes M = max m_s, L = sum l_s exp(m_s - M)
and o = sum acc_s exp(m_s - M) / max(L, 1e-30), in split order.  The
emulation is held to the plain version and to the reference Pallas kernel
in interpret mode at every ``PAGED_CASES`` shape of
``tests/test_torch_kernels.py``, both table orders, at the f32 tolerance
(atol 2e-5, rtol 1e-4), and at extreme logits.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_kv_decode import paged_decode_attention as jax_paged
from repro_torch.capture import kernels as cap
from repro_torch.kernels.paged_kv_decode import paged_decode_ref
from repro_torch.kernels.paged_kv_decode.plan import SPLITS_PER_SM, split_plan
from repro_torch.serving import scenario as srv

F32 = dict(atol=2e-5, rtol=1e-4)
H100_SMS = 132   # streaming multiprocessors of an H100 SXM
NEG_INF = -1e30
PAGED_CASES = [
    # (h, d, n_pages, page, n_active), as tests/test_torch_kernels.py
    (1, 128, 32, 16, 8),
    (8, 128, 64, 32, 16),
    (4, 256, 16, 8, 16),
    (2, 128, 64, 16, 1),
]


def split_combine(q, k_pages, v_pages, page_table, per_split: int,
                  stage_pages: int = 1) -> torch.Tensor:
    """The kernel's arithmetic in f32: splits of ``per_split`` table
    entries, each walked ``stage_pages`` pages a stage with the online
    softmax, then the combine in split order."""
    h, d = q.shape
    q = q.float()
    scale = d ** -0.5
    ms, ls, accs = [], [], []
    for s0 in range(0, len(page_table), per_split):
        m = torch.full((h, 1), NEG_INF)
        l = torch.zeros(h, 1)
        acc = torch.zeros(h, d)
        pages = page_table[s0:s0 + per_split].long()
        for p0 in range(0, len(pages), stage_pages):
            k = k_pages[pages[p0:p0 + stage_pages]].reshape(-1, d).float()
            v = v_pages[pages[p0:p0 + stage_pages]].reshape(-1, d).float()
            sc = (q @ k.T) * scale
            m_new = torch.maximum(m, sc.max(dim=1, keepdim=True).values)
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=1, keepdim=True)
            acc = acc * alpha + p @ v
            m = m_new
        ms.append(m), ls.append(l), accs.append(acc)
    if len(ms) == 1:
        return (accs[0] / torch.clamp(ls[0], min=1e-30)).to(q.dtype)
    m_all = torch.stack(ms).amax(dim=0)
    wts = [torch.exp(m - m_all) for m in ms]
    big_l = sum(l * w for l, w in zip(ls, wts))
    out = sum(a * w for a, w in zip(accs, wts))
    return out / torch.clamp(big_l, min=1e-30)


def _inputs(case):
    h, d, n_pages, page, n_active = case
    rng = np.random.default_rng(h * 1000 + n_pages)
    q = rng.standard_normal((h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, d)).astype(np.float32)
    pt = rng.permutation(n_pages)[:n_active].astype(np.int32)
    return q, kp, vp, pt


def _splits(n_active: int, per: int) -> list[range]:
    return [range(s, min(s + per, n_active)) for s in range(0, n_active, per)]


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n_active", [1, 2, 3, 7, 8, 64, 100, 2048, 65536])
@pytest.mark.parametrize("geo", [(16, 128, 5), (4, 128, 1), (64, 128, 8),
                                 (8, 256, 8), (1, 128, 16)])
def test_plan_covers_the_table_in_order(geo, n_active, itemsize):
    page, d, h = geo
    per, n_splits = split_plan(n_active, page, d, h, itemsize, n_sm=H100_SMS)
    assert 1 <= per <= n_active and n_splits == math.ceil(n_active / per)
    ranges = _splits(n_active, per)
    assert len(ranges) == n_splits
    assert [i for r in ranges for i in r] == list(range(n_active))
    assert all(len(r) >= 1 for r in ranges)
    # at most as many splits as blocks fit on the card at once, each >= 32
    # KB of K and V unless the table is shorter
    assert n_splits <= max(1, SPLITS_PER_SM * H100_SMS)
    assert per * 2 * page * d * itemsize >= 32 * 1024 or n_splits == 1


def _roster_geometries():
    out = {f"roster {tag}": geo for tag, _, geo in cap._GEO_PAGED}
    g = dict(srv._GEO_PAGED)
    out["serving"] = dict(n_pages=g["n_pages"], page=g["page"], d=g["d"],
                          h=g["h"], n_active=g["pages_per_seq"])
    out["full width"] = dict(n_pages=65536, page=16, d=128, h=5,
                             n_active=2048)
    return out


# splits in float32 on an H100 (132 SMs) at the main paths' geometries
WANT_SPLITS = {"roster mqa.p32": 64, "roster gqa8.p32": 22,
               "roster mqa.p64": 32, "roster gqa4.p16": 43, "serving": 1,
               "full width": 256}


@pytest.mark.parametrize("name", list(WANT_SPLITS))
def test_plan_at_the_main_path_geometries(name):
    """One split (one launch, the output written directly) for the serving
    roster's 32-row sequences; splits over the card for the rest."""
    g = _roster_geometries()[name]
    per, n_splits = split_plan(g["n_active"], g["page"], g["d"], g["h"], 4,
                               n_sm=H100_SMS)
    assert n_splits == WANT_SPLITS[name]


# --------------------------------------------------------------------------
# split-then-combine against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_split_combine_matches_reference(case, reverse):
    q, kp, vp, pt = _inputs(case)
    if reverse:
        pt = pt[::-1].copy()
    h, d, _, page, n_active = case
    tq, tk, tv, tpt = (torch.from_numpy(a) for a in (q, kp, vp, pt))
    want_jax = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(pt),
                                    interpret=True))
    want = paged_decode_ref(tq, tk, tv, tpt).numpy()
    plan_per, _ = split_plan(n_active, page, d, h, 4, n_sm=H100_SMS)
    for per in sorted({plan_per, 1, 3, n_active}):
        got = split_combine(tq, tk, tv, tpt, per).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(got, want_jax, **F32)


def test_split_combine_extreme_logits():
    """One split's scores far below another's: its weight exp(m_s - M)
    underflows to 0, with no NaN, and the result is the other split's."""
    h, d, page = 2, 128, 16
    rng = np.random.default_rng(7)
    q = np.full((h, d), 4.0, dtype=np.float32)
    kp = rng.standard_normal((6, page, d)).astype(np.float32)
    kp[:3] = np.abs(kp[:3]) * 20.0      # scores of the first split ~ +1e4
    kp[3:] = -np.abs(kp[3:]) * 20.0     # the second split's ~ -1e4
    vp = rng.standard_normal((6, page, d)).astype(np.float32)
    pt = np.arange(6, dtype=np.int32)
    tq, tk, tv, tpt = (torch.from_numpy(a) for a in (q, kp, vp, pt))
    want = paged_decode_ref(tq, tk, tv, tpt).numpy()
    want_jax = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(pt),
                                    interpret=True))
    for order in (pt, pt[::-1].copy()):
        got = split_combine(tq, tk, tv, torch.from_numpy(order), 3).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(got, want_jax, **F32)


def test_stage_walk_inside_a_split_is_the_same_softmax():
    """Pages walked several to a stage (the kernel's stage of whole pages)
    give the same split result as one page a stage."""
    q, kp, vp, pt = _inputs((8, 128, 64, 32, 16))
    tq, tk, tv, tpt = (torch.from_numpy(a) for a in (q, kp, vp, pt))
    one = split_combine(tq, tk, tv, tpt, 5, stage_pages=1)
    two = split_combine(tq, tk, tv, tpt, 5, stage_pages=2)
    np.testing.assert_allclose(one.numpy(), two.numpy(), **F32)
