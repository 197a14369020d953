"""The port's SSM blocks and the ``ssm`` family (mamba2-780m's smoke
config) against ``repro.models.ssm`` and ``repro.models.LM``.

- ``ssd_chunked`` against the port's ``ssd_ref`` and the reference's, at
  ``tests/test_models.py``'s tolerance (atol 5e-4, rtol 5e-3), with a
  padded last chunk; its final state.
- ``ssm_fwd`` (with ``return_state`` and ``prompt_len``) and
  ``ssm_decode`` at the layer tolerance; ``softplus`` as ``jax.nn``'s.
- The model cases of ``_torch_lm_cases`` (forward, loss, both prefills,
  decode steps, the caches at 1e-4); init and converter for the SSM,
  hybrid and audio families; the right-padding invariant; the short-prompt
  conv tail exactly as the reference takes it; remat changes no value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (KEY, LAYER_TOL, SMOKE_1B, close, layer_cfgs, pair,
                       ref_params, seeded, t, to_np)
from _torch_lm_cases import (  # noqa: F401  (collected here)
    test_forward_logits_and_aux, test_four_decode_steps_after_a_padded_prefill,
    test_loss_with_ignored_labels, test_prefill_logits_cache_and_next_pos)
from repro import configs as ref_configs
from repro.models import LM as RefLM
from repro.models import ssm as RS
from repro_torch import configs
from repro_torch.models import LM, ssm as S
from repro_torch.models.convert import from_reference, to_reference

SSD_TOL = dict(atol=5e-4, rtol=5e-3)


@pytest.fixture(params=["mamba2-780m"])
def arch(request):
    return request.param


def _ssd_inputs(seed: int, b=2, s=40, h=3, p=8, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    c = rng.standard_normal((b, s, n)).astype(np.float32)
    d = (1.0 + 0.5 * rng.standard_normal(h)).astype(np.float32)
    return x, dt, a, bb, c, d


# --------------------------------------------------------------------------
# SSD
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [8, 16, 64])   # 40 % 16 != 0 pads
def test_ssd_chunked_matches_ref_and_the_reference(chunk):
    ins = _ssd_inputs(0)
    tt = [torch.from_numpy(a) for a in ins]
    jj = [jnp.asarray(a) for a in ins]
    got = S.ssd_chunked(*tt, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), S.ssd_ref(*tt).numpy(), **SSD_TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(RS.ssd_chunked(*jj, chunk=chunk)),
                               **SSD_TOL)
    np.testing.assert_allclose(S.ssd_ref(*tt).numpy(),
                               np.asarray(RS.ssd_ref(*jj)), **SSD_TOL)


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_final_state_matches_the_reference(chunk):
    ins = _ssd_inputs(1)
    y, st = S.ssd_chunked(*[torch.from_numpy(a) for a in ins], chunk=chunk,
                          return_final_state=True)
    yw, stw = RS.ssd_chunked(*[jnp.asarray(a) for a in ins], chunk=chunk,
                             return_final_state=True)
    assert st.shape == (2, 3, 5, 8) and st.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), **SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(stw), **SSD_TOL)


def test_softplus_is_logaddexp_everywhere():
    x = np.linspace(-60, 60, 2001).astype(np.float32)
    got = S.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_a_log_init_is_the_references():
    for h in (4, 8, 48, 112):
        want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, h,
                                                dtype=jnp.float32)))
        np.testing.assert_allclose(S.a_log_init(h), want, rtol=1e-6)


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------
def _block(seed: int):
    rcfg, cfg = layer_cfgs("mamba2-780m")
    tree = jax.tree.map(np.asarray, RS.ssm_init(KEY, rcfg))
    rng = np.random.default_rng(seed)
    tree = dict(tree, dt_bias=(0.5 * rng.standard_normal(
        tree["dt_bias"].shape)).astype(np.float32),
        conv_b=(0.2 * rng.standard_normal(
            tree["conv_b"].shape)).astype(np.float32))
    pj = {k: jnp.asarray(v) for k, v in tree.items()}
    pt = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return rcfg, cfg, pj, pt, rng


@pytest.mark.parametrize("prompt_len", [None, (9, 40), (2, 1)],
                         ids=["exact", "padded", "short"])
def test_ssm_fwd_and_its_state(prompt_len):
    rcfg, cfg, pj, pt, rng = _block(2)
    xj, xt = seeded(rng, 2, 40, cfg.d_model)
    plj = None if prompt_len is None else jnp.asarray(prompt_len, jnp.int32)
    plt = None if prompt_len is None else torch.tensor(prompt_len,
                                                       dtype=torch.int32)
    yw, stw = jax.jit(lambda p, x, pl: RS.ssm_fwd(
        p, rcfg, x, return_state=True, prompt_len=pl))(pj, xj, plj)
    y, st = S.ssm_fwd(pt, cfg, xt, return_state=True, prompt_len=plt)
    close(y, yw, tol=SSD_TOL)
    close(st["state"], stw["state"], tol=SSD_TOL)
    close(st["conv"], stw["conv"])


def test_ssm_decode_steps_with_their_state():
    rcfg, cfg, pj, pt, rng = _block(3)
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    cache_j = {"state": jnp.asarray(rng.standard_normal(
        (2, cfg.n_ssm_heads, n, p)).astype(np.float32)),
        "conv": jnp.asarray(rng.standard_normal(
            (2, cfg.ssm_conv - 1, cfg.d_inner + 2 * n)).astype(np.float32))}
    cache_t = {k: torch.from_numpy(np.array(v)) for k, v in cache_j.items()}
    step = jax.jit(lambda p, x, c: RS.ssm_decode(p, rcfg, x, c))
    for i in range(3):
        xj, xt = seeded(rng, 2, 1, cfg.d_model)
        yw, cache_j = step(pj, xj, cache_j)
        y, cache_t = S.ssm_decode(pt, cfg, xt, cache_t)
        close(y, yw, err_msg=f"step {i}")
        close(cache_t["state"], cache_j["state"], err_msg=f"step {i}")
        close(cache_t["conv"], cache_j["conv"], err_msg=f"step {i}")


def test_short_prompt_conv_tail_takes_the_padded_rows():
    """A prompt shorter than ssm_conv - 1 = 3 tokens: the reference's
    clamped ``dynamic_slice`` gives rows 0..2 of the padded input, its
    padding included (ROADMAP queue 3's caveat), not the zero-padded tail
    the unpadded branch makes of the same prompt; the port takes the same
    rows."""
    rcfg, cfg, pj, pt, rng = _block(4)
    xj, xt = seeded(rng, 1, 8, cfg.d_model)
    _, st = S.ssm_fwd(pt, cfg, xt, return_state=True,
                      prompt_len=torch.tensor([2], dtype=torch.int32))
    _, stw = RS.ssm_fwd(pj, rcfg, xj, return_state=True,
                        prompt_len=jnp.asarray([2], jnp.int32))
    np.testing.assert_array_equal(st["conv"].numpy(), np.asarray(stw["conv"]))
    proj = (xt @ pt["w_in"])[..., cfg.d_inner:2 * cfg.d_inner
                             + 2 * cfg.ssm_state]
    torch.testing.assert_close(st["conv"], proj[:, :3], rtol=0, atol=0)
    _, exact = S.ssm_fwd(pt, cfg, xt[:, :2], return_state=True)
    assert torch.equal(exact["conv"][:, 0], torch.zeros_like(proj[:, 0]))
    assert not torch.equal(exact["conv"], st["conv"])


# --------------------------------------------------------------------------
# the family
# --------------------------------------------------------------------------
def test_right_padding_invariant():
    """A prompt right-padded to a bucket (``prompt_len``) leaves the same
    state, logits and next four decode steps as the same prompt alone."""
    _, _, lm, _ = pair("mamba2-780m", dtype="float32")
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, lm.cfg.vocab, (1, 11)).astype(np.int64)
    padded = np.zeros((1, 32), np.int64)
    padded[:, :11] = prompt
    with torch.no_grad():
        lg_a, ca, pa = lm.prefill(torch.from_numpy(prompt),
                                  lm.init_cache(1, 48))
        lg_b, cb, pb = lm.prefill(torch.from_numpy(padded),
                                  lm.init_cache(1, 48),
                                  prompt_len=torch.tensor([11]))
        close(lg_b, to_np(lg_a), tol=LAYER_TOL)
        assert int(pa[0]) == int(pb[0]) == 11
        for k in ("state", "conv"):
            close(cb["ssm"][k], to_np(ca["ssm"][k]), tol=LAYER_TOL)
        for i in range(4):
            tok = torch.from_numpy(rng.integers(1, lm.cfg.vocab, (1, 1)))
            lg_a, ca = lm.decode_step(tok, ca, pa)
            lg_b, cb = lm.decode_step(tok, cb, pb)
            pa, pb = pa + 1, pb + 1
            close(lg_b, to_np(lg_a), tol=LAYER_TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("arch_1b", SMOKE_1B)
def test_init_tree_and_converter_for_the_new_families(arch_1b):
    want = jax.eval_shape(RefLM(ref_configs.get_smoke(arch_1b)).init, KEY)
    want = {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    port = LM(configs.get_smoke(arch_1b), device="cpu").init(
        torch.Generator().manual_seed(0))
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(to_reference(port))[0]}
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == np.float32, k
    tree = ref_params(arch_1b)
    back = to_reference(from_reference(tree, configs.get_smoke(arch_1b),
                                       device="cpu"))
    flat_w = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_w] == [k for k, _ in flat_b]
    for (k, a), (_, b) in zip(flat_w, flat_b):
        assert a.tobytes() == b.tobytes(), jax.tree_util.keystr(k)


def test_converter_refuses_a_missing_or_extra_leaf():
    tree = ref_params("zamba2-7b")
    cfg = configs.get_smoke("zamba2-7b")
    bad = dict(tree, shared_attn={k: v for k, v in tree["shared_attn"].items()
                                  if k != "ln2"})
    with pytest.raises(KeyError, match="shared_attn.ln2"):
        from_reference(bad, cfg, device="cpu")
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra"):
        from_reference(bad, cfg, device="cpu")
    groups = tree["ssm_groups"]
    bad = dict(tree, ssm_groups=jax.tree.map(lambda a: a[:, :4], groups))
    with pytest.raises(ValueError, match="stacked"):
        from_reference(bad, cfg, device="cpu")


def test_remat_changes_no_gradient():
    """``cfg.remat`` (layer bodies under ``torch.utils.checkpoint``) gives
    the gradients of the plain backward pass."""
    lm = from_reference(ref_params("mamba2-780m"),
                        configs.get_smoke("mamba2-780m").replace(
                            dtype="float32"), device="cpu")
    lm.requires_grad_(True)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(1, lm.cfg.vocab, (2, 40)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    grads = []
    for remat in (True, False):
        m = lm.with_config(lm.cfg.replace(remat=remat))
        params = dict(m.named_parameters())
        loss = m.loss(batch)
        grads.append(torch.autograd.grad(loss, list(params.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
