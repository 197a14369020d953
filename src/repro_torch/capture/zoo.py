"""Whole-model zoo: end-to-end model steps swept along their axes
(counterpart of ``repro.capture.zoo``).

Where :mod:`repro_torch.capture.kernels` captures one kernel launch per
entry, this roster captures a *whole step* of each model-zoo config —
``LM.decode_step`` / ``LM.prefill`` / ``LM.forward`` (eval) or the
:func:`repro_torch.train.step.build_train_step` update — through
:func:`repro_torch.capture.model.capture_model`: every matmul, large
arithmetic op and (if present) kernel launch of the step becomes a
captured op in one shared address space, concatenated in program order
with real producer -> consumer reuse.

The roster is the reference's sweep, entry for entry and in its order:
each of the 10 smoke configs over serving batch size (1 -> 64), decode
KV-cache depth (256 -> 65536) and prefill/eval/train sequence length (128
/ 512), in four modes (decode / prefill / eval / train) — 176 entries.
:func:`class_frontier`, :func:`batch_transitions` and
:func:`geometry_transitions` read where a class changes along an axis.

Modelling conventions, as the reference's:

- Capture is abstract: the LM is built on ``meta`` (its parameters and
  caches are shapes without memory, through a path of this module's own
  that no entry point's ``device=`` reaches), so no weights exist, no
  card runs and the traces are deterministic — entries take no rng and
  are **core-invariant** (data-parallel replication).
- Decode entries capture one token step against a ``cache_len``-token
  KV / state cache at the serving batch size; prefill pushes a whole
  ``seq_len``-token prompt through the cache write path; eval is the
  cache-less teacher-forced forward; train is one full update (forward +
  backward + AdamW) at the training batch size.
- Long traces are sampled down to ``target_refs`` as one contiguous
  centred window (:meth:`~repro_torch.capture.model.ModelCapture
  .walk_window`); short decode traces cycle.
- AI is the whole-step counted FLOPs over the whole-step refs.  Both the
  AI and the six-class verdict are **pinned per entry** in :data:`_PINS`,
  measured through this package's own pipeline by ``python -m
  repro_torch.capture.pin_zoo``, so building the registry never captures
  a model; captures and windowed traces build lazily, behind bounded LRU
  memos, on first simulation.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from repro_torch.core.tracegen import TraceSpec, Workload

from .model import ModelCapture, capture_model

__all__ = ["ModelZooEntry", "MODEL_ZOO", "ZOO_BY_NAME", "model_workloads",
           "get_capture", "capture_for", "census_for", "class_frontier",
           "batch_transitions", "geometry_frontier", "geometry_transitions",
           "meta_lm"]

# Whole-model entries aim at the captured kernels' simulated-trace scale.
_TARGET_REFS = 200_000

# Trace geometry axes.  Decode serves a 256-token cache by default;
# train/prefill/eval see 128-token sequences; the long points widen the
# per-step working set.
_CACHE_LEN = 256
_CACHE_LONG = 1024
_SEQ_LEN = 128
_SEQ_LONG = 512

# Audio (Whisper) steps need encoder frame embeddings next to the tokens.
_AUDIO_FRAMES = 64


@dataclass(frozen=True)
class ModelZooEntry:
    """Declaration of one whole-model suite entry.

    ``geom`` is the swept geometry — the KV/state cache length for decode,
    the sequence length otherwise; ``0`` means the mode's default.  ``ai``
    is the pinned whole-step arithmetic intensity (counted FLOPs over
    whole-step refs, rounded to 3); ``None`` computes it from a live
    capture (``pin_zoo`` does, to measure the pins).
    """

    name: str                   # model.<config>.<mode>.bs<k>[.cN|.sN]
    config: str                 # repro_torch.configs arch name
    mode: str                   # "decode" | "prefill" | "eval" | "train"
    batch: int
    expected_class: str
    domain: str = "model/dense"  # model/<config family>
    geom: int = 0
    ai: float | None = None
    target_refs: int = _TARGET_REFS
    mlp: float = 8.0
    instr_overhead: float = 2.0

    @property
    def geometry(self) -> int:
        if self.geom:
            return self.geom
        return _CACHE_LEN if self.mode == "decode" else _SEQ_LEN

    def params(self) -> dict:
        return {
            "config": self.config,
            "mode": self.mode,
            "batch": self.batch,
            "target_refs": self.target_refs,
            "l3": "shared",     # data-parallel replication
            "mlp": self.mlp,
            "geometry": (f"cache{self.geometry}" if self.mode == "decode"
                         else f"seq{self.geometry}"),
        }


# The configs' families, mirrored so importing the declarations builds no
# config.
_FAMILIES = {
    "qwen2.5-14b": "dense", "phi4-mini-3.8b": "dense",
    "nemotron-4-340b": "dense", "granite-20b": "dense",
    "deepseek-moe-16b": "moe", "deepseek-v2-lite-16b": "moe",
    "zamba2-7b": "hybrid", "mamba2-780m": "ssm",
    "whisper-large-v3": "audio", "paligemma-3b": "vlm",
}

_CONFIGS = tuple(_FAMILIES)

# Sweep axes, the reference's.  Decode sweeps the batch frontier on every
# config at the default cache; the long-cache axis carries the whole
# frontier on the CI pair (one dense, one SSM config) and a bs8 point
# elsewhere; prefill/eval sweep {1, 8} x {128, 512-subset}; train sweeps
# batch {4, 16} and sequence {128, 512} on the four training configs.
_BATCHES = (1, 4, 8, 16, 32, 64)
_PE_BATCHES = (1, 8)
_LONG_CACHE_FULL = ("qwen2.5-14b", "mamba2-780m")
_LONG_SEQ_CONFIGS = ("qwen2.5-14b", "mamba2-780m", "deepseek-moe-16b",
                     "whisper-large-v3", "zamba2-7b")
_TRAIN_CONFIGS = ("qwen2.5-14b", "deepseek-moe-16b", "mamba2-780m",
                  "zamba2-7b")
# Deep-cache sub-sweep (bs8, every config), where the 1b -> 1a boundary
# lives; the four configs whose asymptote never crosses get one terminal
# point pinning the asymptote itself.
_CACHE_DEEP = (4096, 16384)
_CACHE_TERMINAL = 65536
_ASYMPTOTE_CONFIGS = ("granite-20b", "paligemma-3b",
                      "deepseek-v2-lite-16b", "mamba2-780m")


def _entry_name(config: str, mode: str, batch: int, geom: int) -> str:
    name = f"model.{config}.{mode}.bs{batch}"
    if geom:
        name += f".c{geom}" if mode == "decode" else f".s{geom}"
    return name


def _axes() -> list[tuple[str, str, int, int]]:
    """The swept (config, mode, batch, geom) grid, in roster order."""
    out: list[tuple[str, str, int, int]] = []
    for cfg in _CONFIGS:
        for bs in _BATCHES:
            out.append((cfg, "decode", bs, 0))
        long_batches = _BATCHES if cfg in _LONG_CACHE_FULL else (8,)
        for bs in long_batches:
            out.append((cfg, "decode", bs, _CACHE_LONG))
        for geom in _CACHE_DEEP:
            out.append((cfg, "decode", 8, geom))
        if cfg in _ASYMPTOTE_CONFIGS:
            out.append((cfg, "decode", 8, _CACHE_TERMINAL))
    for mode in ("prefill", "eval"):
        for cfg in _CONFIGS:
            for bs in _PE_BATCHES:
                out.append((cfg, mode, bs, 0))
            if cfg in _LONG_SEQ_CONFIGS:
                for bs in _PE_BATCHES:
                    out.append((cfg, mode, bs, _SEQ_LONG))
    for cfg in _TRAIN_CONFIGS:
        for bs in (4, 16):
            out.append((cfg, "train", bs, 0))
        out.append((cfg, "train", 4, _SEQ_LONG))
    return out


# Pinned (AI, class) per entry, measured through this package's capture ->
# locality -> core-sweep -> classify pipeline by ``python -m
# repro_torch.capture.pin_zoo`` (not copied from the reference's table;
# ``tests/test_torch_zoo.py`` holds them against it).
_PINS: dict[str, tuple[float, str]] = {
    "model.qwen2.5-14b.decode.bs1": (9.687, "1b"),
    "model.qwen2.5-14b.decode.bs4": (22.08, "1b"),
    "model.qwen2.5-14b.decode.bs8": (28.065, "1b"),
    "model.qwen2.5-14b.decode.bs16": (19.173, "1b"),
    "model.qwen2.5-14b.decode.bs32": (18.151, "1b"),
    "model.qwen2.5-14b.decode.bs64": (18.558, "1b"),
    "model.qwen2.5-14b.decode.bs1.c1024": (12.097, "1b"),
    "model.qwen2.5-14b.decode.bs4.c1024": (10.463, "1b"),
    "model.qwen2.5-14b.decode.bs8.c1024": (9.893, "1b"),
    "model.qwen2.5-14b.decode.bs16.c1024": (10.121, "1b"),
    "model.qwen2.5-14b.decode.bs32.c1024": (10.239, "1b"),
    "model.qwen2.5-14b.decode.bs64.c1024": (10.299, "1b"),
    "model.qwen2.5-14b.decode.bs8.c4096": (8.027, "1a"),
    "model.qwen2.5-14b.decode.bs8.c16384": (7.535, "1a"),
    "model.phi4-mini-3.8b.decode.bs1": (9.907, "1b"),
    "model.phi4-mini-3.8b.decode.bs4": (21.099, "1b"),
    "model.phi4-mini-3.8b.decode.bs8": (25.993, "1b"),
    "model.phi4-mini-3.8b.decode.bs16": (15.349, "1b"),
    "model.phi4-mini-3.8b.decode.bs32": (14.14, "1b"),
    "model.phi4-mini-3.8b.decode.bs64": (14.366, "1b"),
    "model.phi4-mini-3.8b.decode.bs8.c1024": (8.197, "1b"),
    "model.phi4-mini-3.8b.decode.bs8.c4096": (6.829, "1a"),
    "model.phi4-mini-3.8b.decode.bs8.c16384": (6.473, "1a"),
    "model.nemotron-4-340b.decode.bs1": (9.849, "1b"),
    "model.nemotron-4-340b.decode.bs4": (27.215, "1b"),
    "model.nemotron-4-340b.decode.bs8": (38.54, "1b"),
    "model.nemotron-4-340b.decode.bs16": (26.415, "1b"),
    "model.nemotron-4-340b.decode.bs32": (24.968, "1b"),
    "model.nemotron-4-340b.decode.bs64": (25.483, "1b"),
    "model.nemotron-4-340b.decode.bs8.c1024": (12.43, "1b"),
    "model.nemotron-4-340b.decode.bs8.c4096": (9.598, "1b"),
    "model.nemotron-4-340b.decode.bs8.c16384": (8.832, "1a"),
    "model.granite-20b.decode.bs1": (10.636, "1b"),
    "model.granite-20b.decode.bs4": (28.912, "1b"),
    "model.granite-20b.decode.bs8": (40.514, "1b"),
    "model.granite-20b.decode.bs16": (24.863, "1b"),
    "model.granite-20b.decode.bs32": (23.323, "1b"),
    "model.granite-20b.decode.bs64": (23.215, "1b"),
    "model.granite-20b.decode.bs8.c1024": (12.542, "1b"),
    "model.granite-20b.decode.bs8.c4096": (10.182, "1b"),
    "model.granite-20b.decode.bs8.c16384": (9.548, "1b"),
    "model.granite-20b.decode.bs8.c65536": (9.387, "1b"),
    "model.deepseek-moe-16b.decode.bs1": (7.93, "1b"),
    "model.deepseek-moe-16b.decode.bs4": (12.554, "1b"),
    "model.deepseek-moe-16b.decode.bs8": (18.568, "1b"),
    "model.deepseek-moe-16b.decode.bs16": (20.132, "1b"),
    "model.deepseek-moe-16b.decode.bs32": (21.502, "1b"),
    "model.deepseek-moe-16b.decode.bs64": (21.423, "1b"),
    "model.deepseek-moe-16b.decode.bs8.c1024": (8.533, "1a"),
    "model.deepseek-moe-16b.decode.bs8.c4096": (6.126, "1a"),
    "model.deepseek-moe-16b.decode.bs8.c16384": (5.428, "1a"),
    "model.deepseek-v2-lite-16b.decode.bs1": (9.302, "1b"),
    "model.deepseek-v2-lite-16b.decode.bs4": (17.773, "1b"),
    "model.deepseek-v2-lite-16b.decode.bs8": (28.127, "1b"),
    "model.deepseek-v2-lite-16b.decode.bs16": (28.677, "1b"),
    "model.deepseek-v2-lite-16b.decode.bs32": (30.968, "1b"),
    "model.deepseek-v2-lite-16b.decode.bs64": (30.839, "1b"),
    "model.deepseek-v2-lite-16b.decode.bs8.c1024": (16.194, "1b"),
    "model.deepseek-v2-lite-16b.decode.bs8.c4096": (14.438, "1b"),
    "model.deepseek-v2-lite-16b.decode.bs8.c16384": (13.912, "1b"),
    "model.deepseek-v2-lite-16b.decode.bs8.c65536": (13.774, "1b"),
    "model.zamba2-7b.decode.bs1": (5.433, "1b"),
    "model.zamba2-7b.decode.bs4": (13.333, "1b"),
    "model.zamba2-7b.decode.bs8": (9.46, "1b"),
    "model.zamba2-7b.decode.bs16": (9.663, "1b"),
    "model.zamba2-7b.decode.bs32": (9.922, "1b"),
    "model.zamba2-7b.decode.bs64": (10.139, "1b"),
    "model.zamba2-7b.decode.bs8.c1024": (7.486, "1a"),
    "model.zamba2-7b.decode.bs8.c4096": (6.125, "1b"),
    "model.zamba2-7b.decode.bs8.c16384": (5.464, "1a"),
    "model.mamba2-780m.decode.bs1": (5.351, "1b"),
    "model.mamba2-780m.decode.bs4": (15.099, "1b"),
    "model.mamba2-780m.decode.bs8": (10.324, "1b"),
    "model.mamba2-780m.decode.bs16": (11.456, "1b"),
    "model.mamba2-780m.decode.bs32": (12.12, "1b"),
    "model.mamba2-780m.decode.bs64": (12.482, "1b"),
    "model.mamba2-780m.decode.bs1.c1024": (5.351, "1b"),
    "model.mamba2-780m.decode.bs4.c1024": (15.099, "1b"),
    "model.mamba2-780m.decode.bs8.c1024": (10.324, "1b"),
    "model.mamba2-780m.decode.bs16.c1024": (11.456, "1b"),
    "model.mamba2-780m.decode.bs32.c1024": (12.12, "1b"),
    "model.mamba2-780m.decode.bs64.c1024": (12.482, "1b"),
    "model.mamba2-780m.decode.bs8.c4096": (10.324, "1b"),
    "model.mamba2-780m.decode.bs8.c16384": (10.324, "1b"),
    "model.mamba2-780m.decode.bs8.c65536": (10.324, "1b"),
    "model.whisper-large-v3.decode.bs1": (7.98, "1b"),
    "model.whisper-large-v3.decode.bs4": (14.071, "1b"),
    "model.whisper-large-v3.decode.bs8": (16.122, "1b"),
    "model.whisper-large-v3.decode.bs16": (12.786, "1b"),
    "model.whisper-large-v3.decode.bs32": (12.322, "1b"),
    "model.whisper-large-v3.decode.bs64": (12.496, "1b"),
    "model.whisper-large-v3.decode.bs8.c1024": (7.016, "1a"),
    "model.whisper-large-v3.decode.bs8.c4096": (5.665, "1a"),
    "model.whisper-large-v3.decode.bs8.c16384": (5.307, "1a"),
    "model.paligemma-3b.decode.bs1": (11.745, "1b"),
    "model.paligemma-3b.decode.bs4": (28.803, "1b"),
    "model.paligemma-3b.decode.bs8": (38.003, "1b"),
    "model.paligemma-3b.decode.bs16": (20.931, "1b"),
    "model.paligemma-3b.decode.bs32": (19.193, "1b"),
    "model.paligemma-3b.decode.bs64": (19.588, "1b"),
    "model.paligemma-3b.decode.bs8.c1024": (11.58, "1b"),
    "model.paligemma-3b.decode.bs8.c4096": (9.917, "1b"),
    "model.paligemma-3b.decode.bs8.c16384": (9.481, "1b"),
    "model.paligemma-3b.decode.bs8.c65536": (9.37, "1b"),
    "model.qwen2.5-14b.prefill.bs1": (39.646, "1b"),
    "model.qwen2.5-14b.prefill.bs8": (28.28, "1b"),
    "model.qwen2.5-14b.prefill.bs1.s512": (18.528, "1b"),
    "model.qwen2.5-14b.prefill.bs8.s512": (18.083, "1b"),
    "model.phi4-mini-3.8b.prefill.bs1": (27.145, "1b"),
    "model.phi4-mini-3.8b.prefill.bs8": (21.008, "1b"),
    "model.nemotron-4-340b.prefill.bs1": (48.22, "1b"),
    "model.nemotron-4-340b.prefill.bs8": (39.885, "1b"),
    "model.granite-20b.prefill.bs1": (41.191, "1b"),
    "model.granite-20b.prefill.bs8": (30.689, "1b"),
    "model.deepseek-moe-16b.prefill.bs1": (59.711, "1b"),
    "model.deepseek-moe-16b.prefill.bs8": (48.94, "1b"),
    "model.deepseek-moe-16b.prefill.bs1.s512": (28.168, "1b"),
    "model.deepseek-moe-16b.prefill.bs8.s512": (27.882, "1b"),
    "model.deepseek-v2-lite-16b.prefill.bs1": (61.018, "1b"),
    "model.deepseek-v2-lite-16b.prefill.bs8": (51.61, "1b"),
    "model.zamba2-7b.prefill.bs1": (29.771, "1b"),
    "model.zamba2-7b.prefill.bs8": (18.133, "1b"),
    "model.zamba2-7b.prefill.bs1.s512": (22.256, "1b"),
    "model.zamba2-7b.prefill.bs8.s512": (16.868, "1b"),
    "model.mamba2-780m.prefill.bs1": (27.84, "1b"),
    "model.mamba2-780m.prefill.bs8": (16.662, "1b"),
    "model.mamba2-780m.prefill.bs1.s512": (25.033, "1b"),
    "model.mamba2-780m.prefill.bs8.s512": (16.424, "1b"),
    "model.whisper-large-v3.prefill.bs1": (35.596, "1b"),
    "model.whisper-large-v3.prefill.bs8": (23.298, "1b"),
    "model.whisper-large-v3.prefill.bs1.s512": (17.077, "1b"),
    "model.whisper-large-v3.prefill.bs8.s512": (16.745, "1b"),
    "model.paligemma-3b.prefill.bs1": (27.262, "1b"),
    "model.paligemma-3b.prefill.bs8": (20.676, "1b"),
    "model.qwen2.5-14b.eval.bs1": (48.996, "1b"),
    "model.qwen2.5-14b.eval.bs8": (34.095, "1b"),
    "model.qwen2.5-14b.eval.bs1.s512": (20.82, "1b"),
    "model.qwen2.5-14b.eval.bs8.s512": (20.318, "1b"),
    "model.phi4-mini-3.8b.eval.bs1": (34.688, "1b"),
    "model.phi4-mini-3.8b.eval.bs8": (26.266, "1b"),
    "model.nemotron-4-340b.eval.bs1": (56.239, "1b"),
    "model.nemotron-4-340b.eval.bs8": (45.554, "1b"),
    "model.granite-20b.eval.bs1": (50.279, "1b"),
    "model.granite-20b.eval.bs8": (36.492, "1b"),
    "model.deepseek-moe-16b.eval.bs1": (65.39, "1b"),
    "model.deepseek-moe-16b.eval.bs8": (52.516, "1b"),
    "model.deepseek-moe-16b.eval.bs1.s512": (30.035, "1b"),
    "model.deepseek-moe-16b.eval.bs8.s512": (29.72, "1b"),
    "model.deepseek-v2-lite-16b.eval.bs1": (66.629, "1b"),
    "model.deepseek-v2-lite-16b.eval.bs8": (55.171, "1b"),
    "model.zamba2-7b.eval.bs1": (32.891, "1b"),
    "model.zamba2-7b.eval.bs8": (19.916, "1b"),
    "model.zamba2-7b.eval.bs1.s512": (24.065, "1b"),
    "model.zamba2-7b.eval.bs8.s512": (18.292, "1b"),
    "model.mamba2-780m.eval.bs1": (38.69, "1b"),
    "model.mamba2-780m.eval.bs8": (22.707, "1b"),
    "model.mamba2-780m.eval.bs1.s512": (33.492, "1b"),
    "model.mamba2-780m.eval.bs8.s512": (22.436, "1b"),
    "model.whisper-large-v3.eval.bs1": (38.767, "1b"),
    "model.whisper-large-v3.eval.bs8": (25.797, "1b"),
    "model.whisper-large-v3.eval.bs1.s512": (19.105, "1b"),
    "model.whisper-large-v3.eval.bs8.s512": (18.569, "1b"),
    "model.paligemma-3b.eval.bs1": (36.236, "1b"),
    "model.paligemma-3b.eval.bs8": (26.783, "1b"),
    "model.qwen2.5-14b.train.bs4": (24.85, "1b"),
    "model.qwen2.5-14b.train.bs16": (25.435, "1b"),
    "model.qwen2.5-14b.train.bs4.s512": (17.429, "1b"),
    "model.deepseek-moe-16b.train.bs4": (29.628, "1b"),
    "model.deepseek-moe-16b.train.bs16": (36.798, "1b"),
    "model.deepseek-moe-16b.train.bs4.s512": (23.882, "1b"),
    "model.mamba2-780m.train.bs4": (15.501, "1b"),
    "model.mamba2-780m.train.bs16": (15.499, "1b"),
    "model.mamba2-780m.train.bs4.s512": (14.018, "1b"),
    "model.zamba2-7b.train.bs4": (15.213, "1b"),
    "model.zamba2-7b.train.bs16": (15.112, "1b"),
    "model.zamba2-7b.train.bs4.s512": (13.475, "1b"),
}


def _zoo() -> tuple[ModelZooEntry, ...]:
    out = []
    for cfg, mode, batch, geom in _axes():
        name = _entry_name(cfg, mode, batch, geom)
        ai, cls = _PINS.get(name, (None, "1b"))
        out.append(ModelZooEntry(
            name=name, config=cfg, mode=mode, batch=batch,
            expected_class=cls, domain=f"model/{_FAMILIES[cfg]}",
            geom=geom, ai=ai))
    return tuple(out)


MODEL_ZOO: tuple[ModelZooEntry, ...] = _zoo()
ZOO_BY_NAME: dict[str, ModelZooEntry] = {s.name: s for s in MODEL_ZOO}


# ---------------------------------------------------------------------------
# Pinned class-boundary queries (declaration algebra, no capture).
# ---------------------------------------------------------------------------
def _transitions(frontier: dict) -> dict:
    return {key: tuple((a0, c0, a1, c1)
                       for (a0, c0), (a1, c1) in zip(seq, seq[1:])
                       if c0 != c1)
            for key, seq in frontier.items()}


def class_frontier() -> dict[tuple[str, str, int], tuple[tuple[int, str], ...]]:
    """``(config, mode, geometry) -> ((batch, class), ...)`` by batch: the
    pinned class sequence along each swept batch axis."""
    axes: dict[tuple[str, str, int], list[tuple[int, str]]] = {}
    for s in MODEL_ZOO:
        axes.setdefault((s.config, s.mode, s.geometry), []).append(
            (s.batch, s.expected_class))
    return {k: tuple(sorted(v)) for k, v in axes.items()}


def batch_transitions() -> dict[tuple[str, str, int],
                                tuple[tuple[int, str, int, str], ...]]:
    """``(config, mode, geometry) -> ((batch_lo, class_lo, batch_hi,
    class_hi), ...)``: one tuple per adjacent pair of batch points whose
    pinned class differs (``()`` for a constant axis)."""
    return _transitions(class_frontier())


def geometry_frontier() -> dict[tuple[str, str, int],
                                tuple[tuple[int, str], ...]]:
    """``(config, mode, batch) -> ((geometry, class), ...)`` by geometry:
    the pinned class sequence along each swept cache/sequence axis."""
    axes: dict[tuple[str, str, int], list[tuple[int, str]]] = {}
    for s in MODEL_ZOO:
        axes.setdefault((s.config, s.mode, s.batch), []).append(
            (s.geometry, s.expected_class))
    return {k: tuple(sorted(v)) for k, v in axes.items()}


def geometry_transitions() -> dict[tuple[str, str, int],
                                   tuple[tuple[int, str, int, str], ...]]:
    """``(config, mode, batch) -> ((geom_lo, class_lo, geom_hi, class_hi),
    ...)`` for each adjacent pair of geometry points whose pinned class
    differs: where the zoo's 1b -> 1a boundary lives."""
    return _transitions(geometry_frontier())


# ---------------------------------------------------------------------------
# Lazy capture + trace memos, bounded: a 176-entry roster would otherwise
# pin hundreds of MB of windowed traces.  The census is tiny and kept
# whole, so an evicted capture never rebuilds just to report op counts.
# ---------------------------------------------------------------------------
class _LRU(OrderedDict):
    def __init__(self, cap: int) -> None:
        super().__init__()
        self.cap = cap

    def get_or(self, key, build):
        got = self.get(key)
        if got is not None:
            self.move_to_end(key)
            return got
        got = build()
        self[key] = got
        while len(self) > self.cap:
            self.popitem(last=False)
        return got


_CAPTURES: _LRU = _LRU(16)
_TRACES: _LRU = _LRU(48)

# name -> (model_ops, dense_ops, stream_ops, pallas_ops, footprint_mib,
#          whole_refs): filled on first capture, never evicted.
_CENSUS: dict[str, tuple] = {}


def meta_lm(config, *, smoke: bool = True):
    """The LM of ``config`` (an architecture's name: its smoke config, or
    the full one; or a ``ModelConfig`` itself) on the ``meta`` device:
    parameters that are shapes without memory, for an abstract capture or
    the launch layer's dry run.  ``LM.__init__`` resolves its ``device=``
    through :func:`repro_torch.device.resolve_device`, which refuses
    ``meta`` for every entry point; this builds the same module beside
    it."""
    import torch

    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models.model import LM, param_spec

    if not isinstance(config, str):
        cfg = config
    else:
        cfg = configs.get_smoke(config) if smoke else configs.get(config)
    lm = LM.__new__(LM)
    L.ParamTree.__init__(lm, param_spec(cfg), torch.device("meta"))
    lm.cfg = cfg
    return lm


def _meta(shape, dtype=None):
    import torch

    return torch.empty(shape, dtype=dtype or torch.float32, device="meta")


def _tokens(batch: int, seq: int, device="meta"):
    import torch

    return torch.zeros((batch, seq), dtype=torch.int32, device=device)


def _audio_embed(lm, batch: int, frames: int = _AUDIO_FRAMES):
    return _meta((batch, frames, lm.cfg.d_model))


def _no_grad(fn):
    import torch

    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def capture_decode(lm, batch: int, cache_len: int, *,
                   name: str) -> ModelCapture:
    """One decode step of ``lm`` at ``batch`` against a ``cache_len``-token
    cache, its tokens and positions on the LM's device (``meta`` for the
    zoo; a real device gives the same capture, with arithmetic)."""
    import torch

    cache = lm.init_cache(batch, cache_len)
    pos = torch.zeros((batch,), dtype=torch.int32, device=lm.device)
    return capture_model(_no_grad(lm.decode_step),
                         (_tokens(batch, 1, lm.device), cache, pos),
                         name=name)


def _capture_decode(config: str, batch: int, cache_len: int) -> ModelCapture:
    return capture_decode(meta_lm(config), batch, cache_len,
                          name=f"{config}.decode.bs{batch}.c{cache_len}")


def _capture_prefill(config: str, batch: int, seq: int) -> ModelCapture:
    lm = meta_lm(config)
    cache = lm.init_cache(batch, seq)
    name = f"{config}.prefill.bs{batch}.s{seq}"
    if lm.cfg.family == "audio":
        # The cross-KV cache holds enc_ctx encoder outputs and the smoke
        # encoder does not downsample, so prefill frames == enc_ctx.
        embed = _audio_embed(lm, batch, lm.cfg.enc_ctx)
        return capture_model(
            _no_grad(lambda t, c, e: lm.prefill(t, c, extra_embed=e)),
            (_tokens(batch, seq), cache, embed), name=name)
    return capture_model(_no_grad(lm.prefill), (_tokens(batch, seq), cache),
                         name=name)


def _capture_eval(config: str, batch: int, seq: int) -> ModelCapture:
    lm = meta_lm(config)
    name = f"{config}.eval.bs{batch}.s{seq}"
    if lm.cfg.family == "audio":
        return capture_model(
            _no_grad(lambda t, e: lm.forward(t, extra_embed=e)),
            (_tokens(batch, seq), _audio_embed(lm, batch)), name=name)
    return capture_model(_no_grad(lambda t: lm.forward(t)),
                         (_tokens(batch, seq),), name=name)


def _capture_train(config: str, batch: int, seq: int) -> ModelCapture:
    import torch

    from repro_torch.train import optimizer as O
    from repro_torch.train import step as T

    lm = meta_lm(config)
    opt_cfg = O.AdamWConfig()
    step = T.build_train_step(lm, opt_cfg, microbatches=1)
    state = T.init_train_state(lm, opt_cfg)
    tok = _tokens(batch, seq)
    batch_d = {"tokens": tok, "labels": tok}
    if lm.cfg.family == "audio":
        batch_d["extra_embed"] = _audio_embed(lm, batch)
    with torch.enable_grad():
        return capture_model(step, (state, batch_d),
                             name=f"{config}.train.bs{batch}.s{seq}")


_BUILDERS = {
    "decode": _capture_decode,
    "prefill": _capture_prefill,
    "eval": _capture_eval,
    "train": _capture_train,
}


def get_capture(config: str, mode: str, batch: int,
                geom: int | None = None) -> ModelCapture:
    """The memoized whole-step capture behind one zoo entry.  ``geom`` is
    the cache length (decode) or sequence length; ``None`` or ``0`` means
    the mode's default."""
    if geom is None or geom == 0:
        geom = _CACHE_LEN if mode == "decode" else _SEQ_LEN
    key = (config, mode, batch, geom)

    def build() -> ModelCapture:
        mc = _BUILDERS[mode](config, batch, geom)
        name = _entry_name(config, mode, batch,
                           0 if geom in (_CACHE_LEN, _SEQ_LEN) else geom)
        if name not in _CENSUS:
            _CENSUS[name] = census(mc)
        return mc

    return _CAPTURES.get_or(key, build)


def census(mc: ModelCapture) -> tuple:
    """``(model_ops, dense_ops, stream_ops, pallas_ops, footprint_mib,
    whole_refs)`` of one capture."""
    kinds = mc.op_kinds
    return (len(mc.ops), kinds.get("dense", 0), kinds.get("stream", 0),
            kinds.get("pallas", 0),
            round(mc.footprint_words * 8 / 2**20, 3),
            mc.walk(count_only=True).refs)


def capture_for(spec: ModelZooEntry | str) -> ModelCapture:
    """The capture behind a zoo entry (or entry name)."""
    if isinstance(spec, str):
        spec = ZOO_BY_NAME[spec]
    return get_capture(spec.config, spec.mode, spec.batch, spec.geometry)


def census_for(name: str) -> tuple:
    """``(model_ops, dense_ops, stream_ops, pallas_ops, footprint_mib)``
    of one entry, from the census cache (capturing only on a cold miss)."""
    if name not in _CENSUS:
        capture_for(name)
    return _CENSUS[name][:5]


def _spec_ai(spec: ModelZooEntry) -> float:
    """The entry's whole-step AI: pinned, or computed from a live capture
    (count-only walks) while measuring the pins."""
    if spec.ai is not None:
        return spec.ai
    mc = capture_for(spec)
    whole_refs = _CENSUS[spec.name][5] if spec.name in _CENSUS \
        else mc.walk(count_only=True).refs
    return round(mc.flops / whole_refs, 3) if whole_refs else 0.0


def _trace(spec: ModelZooEntry) -> np.ndarray:
    """Windowed/cycled trace, once per entry (the traces are
    core-invariant)."""
    def build() -> np.ndarray:
        addr = capture_for(spec).walk_window(spec.target_refs).addresses
        if addr.size != spec.target_refs:
            addr = np.resize(addr, spec.target_refs)
        return addr

    return _TRACES.get_or(spec.name, build)


def _make_gen(spec: ModelZooEntry):
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        del cores, rng  # data-parallel + deterministic abstract trace
        return TraceSpec(
            addresses=_trace(spec),
            l3_factor=1.0,          # replicated batch shards share the L3
            mlp=spec.mlp,
            dram_rows_irregular=False,
        )
    return gen


def select(only: tuple[str, ...] | None,
           specs: tuple[ModelZooEntry, ...] = MODEL_ZOO
           ) -> tuple[ModelZooEntry, ...]:
    """The entries whose name contains any of ``only`` (all for None)."""
    return tuple(s for s in specs
                 if only is None or any(sub in s.name for sub in only))


def model_workloads(
    specs: tuple[ModelZooEntry, ...] = MODEL_ZOO,
    *,
    only: tuple[str, ...] | None = None,
) -> list[Workload]:
    """Wrap zoo entries as pipeline-ready ``Workload``\\ s.

    With every entry's AI pinned this captures nothing (a capture runs
    when a workload's trace is first simulated).  ``only`` keeps entries
    whose name contains any of the substrings; filtering never changes a
    trace or a fingerprint, so store rows recall across differently
    filtered runs.
    """
    out: list[Workload] = []
    for spec in select(only, specs):
        ai = _spec_ai(spec)
        out.append(Workload(
            name=spec.name,
            family=f"model-{spec.mode}",
            expected_class=spec.expected_class,
            ai_ops_per_access=ai,
            instr_per_access=round(ai + spec.instr_overhead, 3),
            gen=_make_gen(spec),
            core_invariant=True,
        ))
    return out
