"""Paged decode at every grouped-head count, head width D % 8 == 0 up to
512 and page size, on the CPU.

The kernel (``csrc/paged_kv_decode.cu``) holds ``plan.lanes_vec(D)``
columns a lane (D rounded up to DP = 32 of them, the lanes past D reading
the zeroed places of the stage rows), cuts a group of H heads into
``plan.head_groups`` of at most ``plan.head_cap`` heads (one block a split
and head group, all of a split's groups walking the same pages), and walks
a split's rows ``plan.stage_rows`` at a time, a page larger than a stage in
chunks of rows.  :func:`paged_emulation` does that arithmetic in float32:
each split runs every head's online softmax (natural exp, running max
from -1e30) stage by stage, the 8 warps each accumulating the rows
``r % 8 == w`` of a stage, summed in warp order at the end (a head's
arithmetic is its own, whichever head group's block holds it); the
combine folds the splits in order.  It is held against the reference's Pallas
kernel in interpret mode (which takes any H, D and page) and the port's
plain version at H in {1, 12, 17, 48}, D in {8, 64, 112, 192, 384, 512}
and page in {1, 4, 256}, at the f32 tolerance (atol 2e-5, rtol 1e-4),
with the plan's split and with several splits.  The refusals that remain
(D % 8 != 0, D above 512) name ROADMAP.md.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.paged_kv_decode import paged_decode_attention as jax_paged
from repro_torch.kernels.paged_kv_decode import paged_decode, paged_decode_ref
from repro_torch.kernels.paged_kv_decode.plan import (LANE_VECS,
                                                      MAX_HEAD_DIM,
                                                      STAGE_ELEMS, head_cap,
                                                      head_groups, lanes_vec,
                                                      split_plan, stage_rows)

F32 = dict(atol=2e-5, rtol=1e-4)
H100_SMS = 132
NEG_INF = -1e30
WARPS = 8
HEADS = (1, 12, 17, 48)
WIDTHS = (8, 64, 112, 192, 384, 512)
PAGES = (1, 4, 256)
SMEM_PER_BLOCK = 232_448


def paged_emulation(q, k_pages, v_pages, page_table, per: int):
    """paged_split + paged_combine in float32: splits of ``per`` table
    entries, each walked ``plan.stage_rows`` rows a stage at the padded
    width.  Each head's online softmax is its own, so the blocks of the
    ``plan.head_groups`` (which cover every head once,
    :func:`test_head_groups_cover_the_group`) compute what one walk over
    all heads computes; the walk takes them together."""
    h, d = q.shape
    page = k_pages.shape[1]
    dp = 32 * lanes_vec(d)
    rows_a_stage = stage_rows(d, page)
    pad = (0, dp - d)
    q = F.pad(q.float(), pad)
    scale = d ** -0.5
    n_active = len(page_table)
    parts = []
    for s0 in range(0, n_active, per):
        pages = page_table[s0:s0 + per].long()
        kt = F.pad(k_pages[pages].float(), pad)
        vt = F.pad(v_pages[pages].float(), pad)
        kt, vt = kt.reshape(-1, dp), vt.reshape(-1, dp)
        m = torch.full((h, 1), NEG_INF)
        l = torch.zeros(h, 1)
        warps = torch.zeros(WARPS, h, dp)
        for r0 in range(0, kt.shape[0], rows_a_stage):
            ks = kt[r0:r0 + rows_a_stage]
            vs = vt[r0:r0 + rows_a_stage]
            sc = (q @ ks.T) * scale
            m_new = torch.maximum(m, sc.max(dim=1, keepdim=True).values)
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=1, keepdim=True)
            # warp w takes the stage's rows r % WARPS == w
            short = -p.shape[1] % WARPS
            pw = F.pad(p, (0, short)).reshape(h, -1, WARPS)
            vw = F.pad(vs, (0, 0, 0, short)).reshape(-1, WARPS, dp)
            warps = warps * alpha + torch.einsum("hkw,kwd->whd", pw, vw)
            m = m_new
        acc = warps[0]
        for w in range(1, WARPS):
            acc = acc + warps[w]
        parts.append((m, l, acc))
    if len(parts) == 1:
        _, l, acc = parts[0]
        return (acc / torch.clamp(l, min=1e-30))[:, :d]
    big_m = parts[0][0]
    for m, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m)
    big_l = torch.zeros_like(big_m)
    out = torch.zeros(h, dp)
    for m, l, acc in parts:                 # in split order
        w = torch.exp(m - big_m)
        big_l = big_l + l * w
        out = out + acc * w
    return (out / torch.clamp(big_l, min=1e-30))[:, :d]


def _inputs(h: int, d: int, page: int):
    n_active = 2 if page == 256 else 6
    n_pages = n_active + 2
    rng = np.random.default_rng(h * 1000 + d * 10 + page)
    q = rng.standard_normal((h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, d)).astype(np.float32)
    pt = rng.permutation(n_pages)[:n_active].astype(np.int32)
    return q, kp, vp, pt


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("h", HEADS)
def test_split_matches_reference_kernel(h, d, page):
    q, kp, vp, pt = _inputs(h, d, page)
    want_jax = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(pt),
                                    interpret=True))
    tq, tk, tv, tpt = (torch.from_numpy(a) for a in (q, kp, vp, pt))
    want = paged_decode_ref(tq, tk, tv, tpt).numpy()
    np.testing.assert_allclose(paged_decode(tq, tk, tv, tpt).numpy(),
                               want_jax, **F32)
    n_active = len(pt)
    plan_per, _ = split_plan(n_active, page, d, h, 4, n_sm=H100_SMS)
    for per in sorted({plan_per, 1, n_active}):
        got = paged_emulation(tq, tk, tv, tpt, per).numpy()
        assert got.shape == (h, d) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want_jax, **F32)
        np.testing.assert_allclose(got, want, **F32)


# --------------------------------------------------------------------------
# the layout: lanes, head groups, stages
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", range(8, MAX_HEAD_DIM + 1, 8))
def test_lanes_cover_every_width(d):
    vec = lanes_vec(d)
    assert vec in LANE_VECS
    assert 32 * vec >= d
    smaller = [v for v in LANE_VECS if v < vec]
    assert not smaller or 32 * max(smaller) < d
    # the main paths' widths run without padding
    if d in (128, 256):
        assert 32 * vec == d


@pytest.mark.parametrize("h", [1, 4, 5, 8, 12, 16, 17, 33, 48, 64, 128])
@pytest.mark.parametrize("d", [8, 64, 112, 128, 192, 256, 384, 512])
def test_head_groups_cover_the_group(h, d):
    n, per = head_groups(h, d)
    cap = head_cap(lanes_vec(d))
    assert per <= cap and n == math.ceil(h / cap)
    firsts = [g * per for g in range(n)]
    sizes = [min(per, h - f) for f in firsts]
    assert all(s >= 1 for s in sizes) and sum(sizes) == h
    # the registers a lane keeps, q and acc of each head: at most those of
    # the D 128 x 16 heads and D 256 x 8 instances
    assert 2 * per * lanes_vec(d) <= 128


def test_head_groups_at_the_repo_configs():
    # granite-20b's MQA group (48 heads over one KV head) in three blocks
    # of 16; nemotron-4-340b's group of 12 at D 192 in two of 6; the main
    # paths' groups (up to 16 heads at D 128) in one
    assert head_groups(48, 128) == (3, 16)
    assert head_groups(12, 192) == (2, 6)
    assert head_groups(1, 112) == (1, 1)
    assert head_groups(16, 128) == (1, 16)
    assert head_groups(8, 256) == (1, 8)


@pytest.mark.parametrize("page", [1, 2, 4, 16, 32, 64, 100, 128, 256, 1024])
@pytest.mark.parametrize("d", [8, 64, 112, 128, 192, 256, 384, 512])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_stage_fits_shared_memory_at_every_page(page, d, itemsize):
    """A stage holds whole pages, one page, or a chunk of one; the split
    kernel's shared memory (two K and two V stage buffers, or the warps'
    accumulators, the scores, the table entries) fits a block."""
    dp = 32 * lanes_vec(d)
    rows = stage_rows(d, page)
    assert rows >= 1
    if page * dp <= STAGE_ELEMS:
        assert rows % page == 0
    elif page * dp <= 2 * STAGE_ELEMS:
        assert rows == page
    else:
        assert rows == STAGE_ELEMS // dp and rows < page
    _, per_group = head_groups(48, d)
    per = split_plan(2048, page, d, 48, itemsize, n_sm=H100_SMS)[0]
    stages = 4 * rows * dp * itemsize
    red = WARPS * per_group * dp * 4
    smem = max(stages, red) + (per_group * rows + 3 * per_group) * 4 + 8 \
        + per * 8
    assert smem <= SMEM_PER_BLOCK


def test_main_path_stages_are_unchanged():
    # D 128: 32-row stages of whole pages up to 32 rows a page, one 64-row
    # page a stage at 64 (the roster's mqa.p64)
    assert [stage_rows(128, p) for p in (4, 16, 32, 64)] == [32, 32, 32, 64]
    assert stage_rows(256, 16) == 16


@pytest.mark.parametrize("h,d", [(48, 128), (12, 192), (1, 112), (8, 512)])
def test_plan_counts_head_groups(h, d):
    n_active = 2048
    per, n_splits = split_plan(n_active, 16, d, h, 4, n_sm=H100_SMS)
    groups = head_groups(h, d)[0]
    assert n_splits == math.ceil(n_active / per)
    # every block (split x head group) in the card's first two waves
    assert n_splits * groups <= 2 * H100_SMS + groups


# --------------------------------------------------------------------------
# what still raises
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [4, 12, 100, 520, 1024])
def test_widths_no_instance_takes_raise_naming_roadmap(d):
    with pytest.raises(ValueError, match="ROADMAP.md"):
        lanes_vec(d)


def test_an_empty_group_raises():
    with pytest.raises(ValueError, match="H >= 1"):
        head_groups(0, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 520])
def test_card_refuses_widths_no_instance_takes(d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q = torch.zeros(4, d, device="cuda")
    pool = torch.zeros(4, 16, d, device="cuda")
    pt = torch.arange(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        paged_decode(q, pool, pool, pt)


@pytest.mark.parametrize("h,d,page", list(itertools.product(
    [3, 48], [40, 200], [3, 300])))
def test_plain_version_takes_every_shape_on_the_cpu(h, d, page):
    """On the CPU every shape is computed (the reference's oracle route
    too): H, D and page outside the kernel's old domain."""
    q, kp, vp, pt = _inputs(h, d, page)
    tq, tk, tv, tpt = (torch.from_numpy(a) for a in (q, kp, vp, pt))
    got = paged_decode(tq, tk, tv, tpt)
    assert got.shape == (h, d) and torch.isfinite(got).all()
