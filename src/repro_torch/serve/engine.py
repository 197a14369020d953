"""Batched serving engine: prefill + slot-based continuous decode.

The port of ``repro.serve.engine``.  A fixed pool of ``max_batch`` slots
shares one preallocated KV cache.  Requests are prefilled one at a time
into a free slot, right-padded to their prompt-length bucket (so the
prefill sees one shape per bucket, not one per length), then all slots
advance together through one batched ``decode_step``; an idle slot goes
through it too.  Finished slots (EOS, token budget, or the cache's
``max_len``) are freed and refilled from the queue — continuous batching.
Admission is FIFO and the free slots a stack (LIFO).

The cache is a dict of tensors on the LM's device; slot bookkeeping
happens on the host.  The LM contract is ``init_cache``, ``cache_axes``
(logical axes with one ``"batch"`` per leaf), a single-slot ``prefill``
with a ``prompt_len`` mask and a batched ``decode_step``.  The LM owns the
cache writes: ``prefill`` writes the slot's view of the cache it is given
(a narrowed view of the engine's tensors) and ``decode_step`` the whole
cache, both in place, so the engine never copies a slot back (where the
reference's engine takes a returned copy).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Request", "Engine", "FramedLM"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] token ids
    max_new_tokens: int = 16
    eos_id: int | None = None
    out_tokens: list[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        if self.eos_id is not None and self.out_tokens and \
                self.out_tokens[-1] == self.eos_id:
            return True
        return len(self.out_tokens) >= self.max_new_tokens


def _map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: (_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


class Engine:
    def __init__(self, lm, *, max_batch: int, max_len: int,
                 prompt_buckets: tuple[int, ...] = (32, 128, 512)):
        self.lm = lm
        self.max_batch = max_batch
        self.max_len = max_len
        self.buckets = tuple(sorted(prompt_buckets))
        self.cache = lm.init_cache(max_batch, max_len)
        self.device = next(iter(_leaves(self.cache))).device
        self.pos = torch.zeros((max_batch,), dtype=torch.int32,
                               device=self.device)
        self.cur_tokens = torch.zeros((max_batch, 1), dtype=torch.int32,
                                      device=self.device)
        self.active: dict[int, Request] = {}     # slot -> request
        self.queue: deque[Request] = deque()
        self._free = list(range(max_batch))
        # per leaf, the index of its batch axis
        self._batch_axis = _map(lambda a: a.index("batch"), lm.cache_axes())

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _slot_cache(self, slot: int) -> dict:
        def take(x, ax):
            return x.narrow(ax, slot, 1)
        return _map(take, self.cache, self._batch_axis)

    def _admit(self) -> None:
        while self._free and self.queue:
            req = self.queue.popleft()
            slot = self._free.pop()
            n = len(req.prompt)
            b = self._bucket(n)
            padded = np.zeros((1, b), np.int32)
            padded[0, :n] = req.prompt  # right-pad; prompt_len masks the rest
            logits, _, next_pos = self.lm.prefill(    # writes the slot
                torch.from_numpy(padded).to(self.device),
                self._slot_cache(slot),
                prompt_len=torch.tensor([n], dtype=torch.int32,
                                        device=self.device))
            tok = int(torch.argmax(logits[0, -1]))
            req.out_tokens.append(tok)
            self.pos[slot] = next_pos[0]
            self.cur_tokens[slot, 0] = tok
            self.active[slot] = req

    # ------------------------------------------------------------------
    def step(self) -> list[tuple[int, int]]:
        """Admit queued requests, run one decode step, return
        [(request_id, emitted_token)] for active slots."""
        self._admit()
        if not self.active:
            return []
        logits, _ = self.lm.decode_step(           # writes the cache
            self.cur_tokens, self.cache, self.pos)
        next_tokens = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
        self.pos = self.pos + 1
        self.cur_tokens = next_tokens[:, None]

        toks, pos = next_tokens.tolist(), self.pos.tolist()
        emitted = []
        for slot in list(self.active):
            req = self.active[slot]
            tok = toks[slot]
            req.out_tokens.append(tok)
            emitted.append((req.rid, tok))
            if req.done or pos[slot] >= self.max_len - 1:
                del self.active[slot]
                self._free.append(slot)
        return emitted

    def run(self, requests: list[Request]) -> dict[int, list[int]]:
        for r in requests:
            self.submit(r)
        while self.queue or self.active:
            self.step()
        return {r.rid: r.out_tokens for r in requests}


class FramedLM:
    """An audio-family LM as the engine calls it: each prefill is given
    ``frames`` ([1, enc_ctx, d] frame embeddings) as its encoder input,
    which the engine does not pass (nor does the reference's, whose
    engine cannot serve that family).  Everything else is the LM's."""

    def __init__(self, lm, frames: torch.Tensor):
        self.lm = lm
        self.frames = frames

    def __getattr__(self, name):
        return getattr(self.lm, name)

    def prefill(self, tokens, cache, *, prompt_len=None):
        return self.lm.prefill(tokens, cache, extra_embed=self.frames,
                               prompt_len=prompt_len)


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
