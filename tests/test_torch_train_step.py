"""The port's training substrate (``repro_torch.train``) against
``repro.train``, in float32 on the CPU.

- optimizer: the cosine schedule, the global norm and two AdamW steps on
  seeded trees (parameters at rtol 1e-6; the bf16 moments within one
  bf16 step, 2^-8 relative, since a float32 difference in the last bit can
  round them the other way);
- compress: the int8 codes of ``_quantize`` (equal, or at most one code
  apart on at most 0.1% of the elements, where XLA's division and
  torch's round a tie differently), the error-feedback identity and its
  telescoping, ``compress_rel_err``;
- the train step (the gradients of every family's smoke LM are held to
  ``jax.value_and_grad`` in ``test_torch_train_grads_*.py``): parameters
  and optimizer state after two steps (see ``_hold_state`` for the bound: the bf16
  gradient cast and Adam's sign-like first steps turn a last-bit
  difference into a whole step on a few elements), microbatching (the
  loss at rtol 1e-5, as the reference's test holds it), the int8
  error-feedback path (one scale per reference leaf, so a stacked leaf's
  layers share theirs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.compress as RC
import repro.train.optimizer as RO
import repro.train.step as RT
from _torch_lm import pair, port_lm, to_np, train_batch
from repro_torch import configs
from repro_torch.models.convert import split_tree
from repro_torch.train import compress as C
from repro_torch.train import optimizer as O
from repro_torch.train import step as T

BF16_STEP = 2.0 ** -8
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)


def _tree(rng, scale=1.0):
    """A seeded tree in both packages: {a: [5, 3], b: {c: [7], d: [2, 2]}}."""
    shapes = {"a": (5, 3), "b.c": (7,), "b.d": (2, 2)}
    flat = {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}
    ref = {"a": jnp.asarray(flat["a"]),
           "b": {"c": jnp.asarray(flat["b.c"]), "d": jnp.asarray(flat["b.d"])}}
    return ref, {k: torch.from_numpy(v.copy()) for k, v in flat.items()}


def _ref_flat(tree) -> dict:
    return {"a": np.asarray(tree["a"]), "b.c": np.asarray(tree["b"]["c"]),
            "b.d": np.asarray(tree["b"]["d"])}


def _bf16_close(got, want, err_msg=""):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=BF16_STEP,
                               atol=1e-30, err_msg=err_msg)


def _off(got, want, tol: dict, bound: dict, err_msg: str) -> tuple[int, int]:
    """(elements outside ``tol``, elements); every one within ``bound``
    (an atol and an rtol)."""
    got, want = to_np(got), to_np(want)
    np.testing.assert_allclose(got, want, **bound, err_msg=err_msg)
    return int((~np.isclose(got, want, **tol)).sum()), got.size


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 100, 500])
def test_cosine_schedule_equals_the_references(step):
    cfg = O.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    rcfg = RO.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    got = O.cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = RO.cosine_schedule(rcfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_global_norm_equals_the_references():
    ref, port = _tree(np.random.default_rng(0))
    np.testing.assert_allclose(O.global_norm(port).item(),
                               float(RO.global_norm(ref)), rtol=1e-6)
    assert O.global_norm({"a": torch.tensor([3.0, 0.0]),
                          "b": {"c": torch.tensor([[4.0]])}}).item() == 5.0


def test_init_opt_state_dtypes_and_shapes():
    _, port = _tree(np.random.default_rng(1))
    st = O.init_opt_state(port, O.AdamWConfig())
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    for tree in (st["mu"], st["nu"]):
        assert list(tree) == ["a", "b.c", "b.d"]
        assert all(v.dtype == torch.bfloat16 and not v.any()
                   for v in tree.values())


@pytest.mark.parametrize("state_dtype", ["bfloat16", "float32"])
def test_two_adamw_steps_equal_the_references(state_dtype):
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=1.0,
              weight_decay=0.1, state_dtype=state_dtype)
    cfg, rcfg = O.AdamWConfig(**kw), RO.AdamWConfig(**kw)
    rng = np.random.default_rng(2)
    ref_p, port_p = _tree(rng)
    ref_st = RO.init_opt_state(ref_p, rcfg)
    port_st = O.init_opt_state(port_p, cfg)
    upd = jax.jit(lambda p, g, s: RO.apply_updates(p, g, s, rcfg))
    for i in range(2):
        ref_g, port_g = _tree(rng, scale=3.0)      # clipped: norm > 1
        ref_p, ref_st, rm = upd(ref_p, ref_g, ref_st)
        port_p, port_st, pm = O.apply_updates(port_p, port_g, port_st, cfg)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(pm["lr"].item(), float(rm["lr"]),
                                   rtol=1e-6)
        for k, w in _ref_flat(ref_p).items():
            np.testing.assert_allclose(port_p[k].numpy(), w, rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {i}")
        for m in ("mu", "nu"):
            for k, w in _ref_flat(ref_st[m]).items():
                assert port_st[m][k].dtype == getattr(torch, state_dtype)
                _bf16_close(port_st[m][k], w, err_msg=f"{m}.{k} step {i}")
        assert int(port_st["step"]) == int(ref_st["step"]) == i + 1


# --------------------------------------------------------------------------
# compress
# --------------------------------------------------------------------------
def test_int8_codes_equal_the_references():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((256, 64)).astype(np.float32)
    x[0, 0] = 7.5                   # an exact scale: 7.5 / 127 a step
    x[1, :8] = 7.5 * np.arange(8) / 127 * 0.5 + 7.5 / 127 * 0.5   # ties
    q, s = C._quantize(torch.from_numpy(x))
    qw, sw = jax.jit(RC._quantize)(jnp.asarray(x))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert s.item() == float(sw)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(qw).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= x.size // 1000


def test_error_feedback_identity_and_rel_err():
    rng = np.random.default_rng(4)
    ref_g, port_g = _tree(rng)
    err = C.init_error_buffers(port_g)
    assert all(v.dtype == torch.float32 and not v.any() for v in err.values())
    deq, err, m = C.compress_decompress(port_g, err)
    rdeq, rerr, rm = RC.compress_decompress(ref_g, RC.init_error_buffers(ref_g))
    for k in port_g:
        np.testing.assert_allclose(err[k].numpy(),
                                   (port_g[k] - deq[k]).numpy(), atol=1e-7)
        np.testing.assert_allclose(deq[k].numpy(), _ref_flat(rdeq)[k],
                                   atol=float(port_g[k].abs().max()) / 127)
    np.testing.assert_allclose(m["compress_rel_err"].item(),
                               float(rm["compress_rel_err"]), rtol=1e-3)
    assert 0.0 < m["compress_rel_err"].item() < 0.02


def test_error_feedback_telescopes():
    g = {"w": torch.full((32,), 0.003)}
    g["w"][0] = 1.0                  # one large value sets the scale
    err = C.init_error_buffers(g)
    total = torch.zeros(32)
    for _ in range(8):
        deq, err, _ = C.compress_decompress(g, err)
        total += deq["w"]
    # what the payloads missed is what the buffer holds, never more than
    # one quantum
    torch.testing.assert_close(total + err["w"], 8 * g["w"], rtol=1e-5,
                               atol=1e-6)
    assert float(err["w"].abs().max()) <= 1.0 / 127


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
def _ref_setup(arch, **step_kw):
    ref, params, _, _ = pair(arch, dtype="float32")
    rcfg = RO.AdamWConfig(warmup_steps=0)
    state = RT.init_train_state(ref, params, rcfg,
                                compress=step_kw.get("compress"))
    return params, state, jax.jit(RT.build_train_step(ref, rcfg, **step_kw))


def _port_setup(arch, **step_kw):
    lm = port_lm(arch)
    cfg = O.AdamWConfig(warmup_steps=0)
    state = T.init_train_state(lm, cfg, compress=step_kw.get("compress"))
    return lm, state, T.build_train_step(lm, cfg, **step_kw)


def _hold_state(lm, state, ref_params_, ref_state, what: str):
    """Parameters at PARAM_TOL and the bf16 moments within one bf16 step,
    but for at most 0.2% of all their elements: gradients that agree
    to 1e-3 (GRAD_TOL) round to bf16 the other way now and then, and a
    gradient element near 0 may change sign, which moves Adam's update
    g / (|g| + eps) by up to 2 lr.  Those stay within 2 lr a step of the
    reference (parameters), and within two bf16 steps (the gradient's
    cast, then the moment's) or 1e-3 of the tensor's largest moment."""
    named = T.train_params(lm)
    n = int(state["adam"]["step"])
    want = split_tree(jax.tree.map(np.asarray, ref_params_), named, lm.cfg)
    counts = [_off(p, want[name], PARAM_TOL,
                   dict(atol=2 * 3e-4 * n + 1e-5, rtol=0), f"{what} {name}")
              for name, p in named.items()]
    for m in ("mu", "nu"):
        want = split_tree(ref_state["adam"][m], named, lm.cfg)
        for name in named:
            w = to_np(want[name])
            counts.append(_off(
                state["adam"][m][name], w, dict(rtol=BF16_STEP, atol=1e-30),
                dict(rtol=4 * BF16_STEP,
                     atol=1e-3 * float(np.abs(w).max()) + 1e-30),
                f"{what} {m}.{name}"))
    off, size = map(sum, zip(*counts))
    assert off <= 2e-3 * size, (what, off, size)
    assert n == int(ref_state["adam"]["step"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "deepseek-moe-16b"])
def test_params_and_opt_state_after_two_steps(arch):
    params, rstate, rstep = _ref_setup(arch)
    lm, state, step = _port_setup(arch)
    for i in range(2):
        batch = train_batch(lm.cfg, 20 + i)
        params, rstate, rm = rstep(params, rstate,
                                   {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(rm["grad_norm"]), rtol=1e-3)
        _hold_state(lm, state, params, rstate, f"step {i}")
    assert lm.embed.grad is None          # grads freed after each step


def test_microbatching_matches_the_full_batch():
    batch = train_batch(configs.get_smoke("mamba2-780m"), 30, b=4)
    losses, states = [], []
    for mb in (1, 2):
        lm, state, step = _port_setup("mamba2-780m", microbatches=mb)
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        losses.append(m["loss"].item())
        states.append((lm, state))
    # the mean of per-microbatch token means is the full batch's mean
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    params, rstate, rstep = _ref_setup("mamba2-780m", microbatches=2)
    params, rstate, rm = rstep(params, rstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(losses[1], float(rm["loss"]), rtol=1e-5)
    _hold_state(*states[1], params, rstate, "microbatches=2")


def test_int8_error_feedback_step_equals_the_references():
    params, rstate, rstep = _ref_setup("mamba2-780m", compress="int8_ef")
    lm, state, step = _port_setup("mamba2-780m", compress="int8_ef")
    assert set(state) == {"adam", "err"}
    batch = train_batch(lm.cfg, 40)
    params, rstate, rm = rstep(params, rstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(state) == {"adam", "err"}
    np.testing.assert_allclose(m["compress_rel_err"].item(),
                               float(rm["compress_rel_err"]), rtol=1e-2)
    assert 0.0 <= m["compress_rel_err"].item() < 0.2
    _hold_state(lm, state, params, rstate, "int8_ef")


def test_eval_step_is_the_loss_without_grad():
    lm = port_lm("mamba2-780m")
    batch = {k: torch.from_numpy(v)
             for k, v in train_batch(lm.cfg, 50).items()}
    out = T.build_eval_step(lm)(batch)
    assert not out.requires_grad
    with torch.no_grad():
        assert out.item() == lm.loss(batch).item()
    assert T.train_state_axes({"w": ("fsdp",)}, compress="int8_ef") == {
        "adam": {"mu": {"w": ("fsdp",)}, "nu": {"w": ("fsdp",)},
                 "step": ()}, "err": {"w": ("fsdp",)}}
