"""Deterministic synthetic token pipeline, sharded per process.

The port of ``repro.data.pipeline``; its batches are the reference's,
byte for byte (both draw them with numpy):

- **Determinism / restartability**: batch ``i`` depends only on
  ``(seed, i)`` through a counter-based generator (Philox), so a restart
  from a checkpointed step reproduces the exact stream; the checkpoint
  needs no loader state beyond the step counter.
- **Process sharding**: each process makes only its ``global_batch /
  world_size`` slice (``torch.distributed``'s world size and rank when it
  is initialized, else 1 and 0), or, given ``data_shards``, its
  ``global_batch / data_shards`` slice; :meth:`SyntheticTokens.
  global_arrays` assembles the slices into one DTensor a key.
- **The same draw on every process**, as the reference's: a slice is the
  first rows of step ``i``'s Philox stream, whatever the process (the
  process index is not in the draw), so the assembled global batch is one
  slice repeated.  The reference divides by the process count; on a mesh
  whose "model" axis is wider than 1 that would assemble fewer rows than
  ``global_batch``, so the port's mesh path divides by the data shards,
  the ranks of one shard holding equal slices (ROADMAP.md queue 3).
- **Prefetch**: a background thread keeps ``prefetch`` batches ready.

The "dataset" is a token stream with a power-law unigram distribution and
a shift structure, so the LM loss has signal.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["SyntheticTokens", "make_batch_specs", "BatchSpec",
           "batch_shards"]


class BatchSpec(NamedTuple):
    """The shape and dtype of one batch entry (the reference returns
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def make_batch_specs(cfg, shape, *, img_tokens: int = 0,
                     enc_ctx: int = 0) -> dict[str, BatchSpec]:
    """Shapes and dtypes of a training batch."""
    b, s = shape.global_batch, shape.seq_len
    specs = {
        "tokens": BatchSpec((b, s), torch.int32),
        "labels": BatchSpec((b, s), torch.int32),
    }
    if img_tokens:
        specs["extra_embed"] = BatchSpec((b, img_tokens, cfg.d_model),
                                         getattr(torch, cfg.dtype))
    if enc_ctx:
        specs["extra_embed"] = BatchSpec((b, enc_ctx, cfg.d_model),
                                         getattr(torch, cfg.dtype))
    return specs


def _process_grid() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass
class SyntheticTokens:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    prefetch: int = 2
    extra_embed_len: int = 0     # VLM patch / audio frame stand-ins
    d_model: int = 0
    zipf_a: float = 1.2
    data_shards: int = 0         # 0: split by the process count

    def __post_init__(self):
        self._procs, self._pid = _process_grid()
        split = self.data_shards or self._procs
        assert self.global_batch % split == 0
        self._local_batch = self.global_batch // split
        self._q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._next_step = 0

    # -- deterministic batch synthesis -----------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=step))
        b, s = self._local_batch, self.seq_len
        # power-law unigrams + shift-structure so bigrams are learnable
        base = rng.zipf(self.zipf_a, size=(b, s + 1)).astype(np.int64)
        tokens = (base + np.arange(s + 1)[None, :] * 7) % self.vocab
        out = {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }
        if self.extra_embed_len:
            out["extra_embed"] = rng.standard_normal(
                (b, self.extra_embed_len, self.d_model), dtype=np.float32)
        return out

    # -- prefetching iterator --------------------------------------------
    def _worker(self):
        step = self._next_step
        while not self._stop.is_set():
            try:
                self._q.put((step, self.batch_at(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def start(self, step: int = 0) -> "SyntheticTokens":
        self._next_step = step
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
            self._thread = None
        while not self._q.empty():
            self._q.get_nowait()

    def __iter__(self):
        while True:
            if self._thread is None:
                yield self.batch_at(self._next_step)
                self._next_step += 1
            else:
                _, batch = self._q.get()
                yield batch

    def global_arrays(self, batch: dict, mesh, batch_spec) -> dict:
        """Assemble this rank's slices into global DTensors on ``mesh``:
        each key's leading axis sharded as ``batch_spec``'s first entry
        (a ``models.sharding`` spec, e.g. ``logical_to_spec(mesh,
        ("batch", None))``), its other axes whole; the global batch has
        ``global_batch`` rows."""
        from torch.distributed.tensor import DTensor

        from repro_torch.models import sharding
        from repro_torch.models.shard_ops import contiguous_stride

        dev = sharding.mesh_device(mesh)
        out = {}
        for k, v in batch.items():
            spec = tuple(batch_spec[:1])     # () on a trivial mesh
            pl = sharding.placements(mesh, spec)
            rows = v.shape[0] * batch_shards(mesh, spec)
            if rows != self.global_batch:
                raise ValueError(
                    f"{k}: {v.shape[0]} rows on each of "
                    f"{batch_shards(mesh, spec)} data shards assemble "
                    f"{rows}, not the global batch of {self.global_batch}")
            shape = (rows, *v.shape[1:])
            local = torch.from_numpy(v).to(dev, non_blocking=True)
            out[k] = DTensor.from_local(local, mesh, pl, run_check=False,
                                        shape=torch.Size(shape),
                                        stride=contiguous_stride(shape))
        return out


def batch_shards(mesh, spec) -> int:
    """How many slices the leading axis of ``spec`` cuts a batch into:
    the product of the mesh axes its first entry names."""
    from repro_torch.models.sharding import mesh_axes

    entry = spec[0] if spec else None
    names = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    sizes = mesh_axes(mesh)
    n = 1
    for name in names:
        n *= sizes[name]
    return n
