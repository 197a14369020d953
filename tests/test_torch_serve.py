"""The port's continuous-batching engine (``repro_torch.serve``).

The behaviours of ``tests/test_serve.py``, on a torch stub LM whose next
token is the successor ``(t + 1) % V``, so every request's stream is
predictable: buckets, one prefill shape per bucket, padding masked by
``prompt_len``, the successor chain, no cross-talk between slots, the
(rid, token) pairs, EOS and ``max_len`` retirement, slot reuse, FIFO
admission with LIFO slots and the slot-cache stamp.  Then the port's
engine over the port's smoke LMs emits the tokens of ``repro.serve``'s
engine over the reference's, with the same parameters; and ``python -m
repro_torch.serve`` runs on the CPU and refuses a missing card.
"""

import jax
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from _torch_lm import ref_params
from repro import configs as ref_configs
from repro.models import LM as RefLM
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro_torch import configs
from repro_torch.models.convert import from_reference
from repro_torch.serve import Engine, Request
from repro_torch.serve.__main__ import main as serve_main

V = 16  # stub vocab


class SuccessorLM:
    """Next token = (current + 1) % V; prefill masks right-padding and
    records the token shapes it was given."""

    def __init__(self):
        self.prefill_shapes = []

    def init_cache(self, batch, max_len):
        return {"k": torch.zeros((batch, max_len))}

    def cache_axes(self):
        return {"k": ("batch", None)}

    def prefill(self, tokens, cache_slice, *, prompt_len):
        self.prefill_shapes.append(tuple(tokens.shape))
        n = int(prompt_len[0])
        # last *valid* token — bucket padding must be invisible
        last = tokens[0, n - 1].long()
        logits = F.one_hot((last + 1) % V, V).float()[None, None, :]
        # stamp the slot in place, as the port's LM writes its cache, so
        # slot reuse is observable from outside
        cache_slice["k"][:, 0] = tokens[0, :n].sum().float()
        return logits, cache_slice, prompt_len

    def decode_step(self, tokens, cache, pos):
        nxt = (tokens[:, 0].long() + 1) % V
        return F.one_hot(nxt, V).float()[:, None, :], cache


def make_engine(max_batch=2, max_len=64, buckets=(8, 32)):
    return Engine(SuccessorLM(), max_batch=max_batch, max_len=max_len,
                  prompt_buckets=buckets)


def req(rid, prompt, **kw):
    return Request(rid=rid, prompt=np.asarray(prompt, np.int32), **kw)


class TestBuckets:
    def test_rounds_up_to_smallest_fitting_bucket(self):
        eng = make_engine(buckets=(8, 32, 128))
        assert eng._bucket(1) == 8
        assert eng._bucket(8) == 8
        assert eng._bucket(9) == 32
        assert eng._bucket(33) == 128

    def test_oversized_prompt_falls_to_last_bucket(self):
        eng = make_engine(buckets=(8, 32))
        assert eng._bucket(500) == 32

    def test_one_prefill_shape_per_bucket_not_per_length(self):
        eng = make_engine(max_batch=4, buckets=(8, 32))
        for rid, n in enumerate((3, 5, 7, 20)):  # 3 in bucket 8, 1 in 32
            eng.submit(req(rid, list(range(1, n + 1)), max_new_tokens=1))
        eng.step()
        assert sorted(eng.lm.prefill_shapes) == [(1, 8)] * 3 + [(1, 32)]

    def test_padding_is_masked_by_prompt_len(self):
        # same last-valid-token, different padding tails -> same chain
        eng = make_engine()
        out = eng.run([req(0, [4], max_new_tokens=2),
                       req(1, [9, 2, 4], max_new_tokens=2)])
        assert out[0] == [5, 6] and out[1] == [5, 6]


class TestDecode:
    def test_successor_chain_prefill_plus_decode(self):
        eng = make_engine()
        out = eng.run([req(0, [3, 5], max_new_tokens=4)])
        # prefill emits 6, three decode steps continue the chain
        assert out[0] == [6, 7, 8, 9]

    def test_concurrent_slots_do_not_cross_talk(self):
        eng = make_engine(max_batch=2)
        out = eng.run([req(0, [1], max_new_tokens=3),
                       req(1, [10], max_new_tokens=3)])
        assert out[0] == [2, 3, 4]
        assert out[1] == [11, 12, 13]

    def test_step_reports_rid_token_pairs(self):
        eng = make_engine()
        eng.submit(req(7, [1], max_new_tokens=2))
        emitted = eng.step()   # admit (prefill -> 2) + one decode (-> 3)
        assert emitted == [(7, 3)]


class TestRetirement:
    def test_eos_frees_slot_early(self):
        eng = make_engine()
        out = eng.run([req(0, [1], max_new_tokens=10, eos_id=4)])
        assert out[0] == [2, 3, 4]
        assert not eng.active and len(eng._free) == eng.max_batch

    def test_max_len_caps_generation(self):
        eng = make_engine(max_len=6)
        out = eng.run([req(0, [1, 2], max_new_tokens=50)])
        # pos: 2 after prefill, retire once pos reaches max_len - 1
        assert len(out[0]) == 4
        assert not eng.active

    def test_slots_are_reused_across_waves(self):
        eng = make_engine(max_batch=2)
        out = eng.run([req(i, [i + 1], max_new_tokens=2) for i in range(4)])
        assert all(len(v) == 2 for v in out.values())
        assert out[3] == [5, 6]
        assert sorted(eng._free) == [0, 1] and not eng.active and not eng.queue

    def test_admission_is_fifo_slots_lifo(self):
        eng = make_engine(max_batch=2)
        eng.submit(req(0, [1], max_new_tokens=5))
        eng.submit(req(1, [2], max_new_tokens=5))
        eng.submit(req(2, [3], max_new_tokens=5))
        eng._admit()
        # first queued request got the top of the free stack (slot 1)
        assert eng.active[1].rid == 0 and eng.active[0].rid == 1
        assert eng.queue[0].rid == 2 and not eng._free

    def test_prefill_stamps_the_slot_cache(self):
        eng = make_engine(max_batch=2)
        eng.submit(req(0, [2, 3, 4], max_new_tokens=1))
        eng._admit()
        (slot,) = eng.active
        assert float(eng.cache["k"][slot, 0]) == 9.0


# --------------------------------------------------------------------------
# The port's engine over real LMs, against the reference's
# --------------------------------------------------------------------------
def _requests(make, vocab: int, n: int = 6, max_new: int = 8):
    """examples/serve_lm.py's burst: prompts of 3-13 tokens from seed 0."""
    rng = np.random.default_rng(0)
    return [make(rid=i, prompt=rng.integers(1, vocab,
                                            size=int(rng.integers(3, 14))),
                 max_new_tokens=max_new)
            for i in range(n)]


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v2-lite-16b",
                                  "mamba2-780m", "zamba2-7b"])
def test_engine_emits_the_reference_engines_tokens(arch):
    rcfg = ref_configs.get_smoke(arch).replace(dtype="float32")
    ref = RefLM(rcfg)
    params = jax.tree.map(jax.numpy.asarray, ref_params(arch))
    want = RefEngine(ref, params, max_batch=4, max_len=64,
                     prompt_buckets=(8, 16)).run(
        _requests(RefRequest, rcfg.vocab))

    lm = from_reference(ref_params(arch),
                        configs.get_smoke(arch).replace(dtype="float32"),
                        device="cpu")
    with torch.inference_mode():
        got = Engine(lm, max_batch=4, max_len=64,
                     prompt_buckets=(8, 16)).run(
            _requests(Request, rcfg.vocab))
    assert got == want
    assert all(len(v) == 8 for v in got.values())


def test_serve_cli_runs_on_the_cpu(capsys):
    assert serve_main(["--device", "cpu", "--requests", "5",
                       "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 5 requests through 4 slots" in out
    assert out.count("-token prompt): [") == 5


def test_serve_cli_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main([])


def test_serve_cli_names_the_next_slice_for_its_families(capsys):
    """The families of the "LM stack, 1b" slice serve now; mamba2-780m is
    the default, as in the reference's example, and the hybrid and audio
    families serve by name."""
    for argv in (["--device", "cpu", "--requests", "2", "--max-new", "2"],
                 ["--device", "cpu", "--arch", "zamba2-7b", "--requests",
                  "2", "--max-new", "2"]):
        assert serve_main(argv) == 0
        assert "served 2 requests through 4 slots" in capsys.readouterr().out
