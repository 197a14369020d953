"""Multi-pod dry run: run every (arch x shape x mesh) cell's step once on
the production mesh, placed but never allocated (the port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 host devices and
reads XLA's analyses.  The port runs the cell's step once, as rank 0 of
the production mesh over a fake process group (no data moves), on
``meta`` DTensors (no memory) built by :func:`~repro_torch.launch.specs.
build_cell`, under a ``TorchDispatchMode`` that sees each op DTensor
dispatches on its local shards and each collective its sharding
propagation inserts.  For each cell that gives, WITHOUT allocating any real
buffer:

- ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``,
  exactly the local shards' bytes of the step's arguments (parameters,
  optimizer state, caches, batch) and of what it returns (a train step's
  parameters, updated in place, included); ``temp_size_in_bytes``, the
  peak of the live local intermediates, tracked by storage (a storage is
  dead once nothing but the recorder holds it) -> proves the cell fits a
  card's 80 GB;
- ``hlo_cost_analysis``: ``flops``, the local ops' arithmetic
  (``capture.flops.eqn_flops``), and ``bytes accessed``, Σ operand plus
  result bytes of every op that is not a view (no fusion: each op reads
  and writes HBM, an upper bound on what a fused step moves);
- ``hlo_collective_bytes_per_iter`` / ``hlo_collective_by_op``: each
  collective's local result bytes, by the reference's op names
  (``core.hlo_analysis.collective_stats``), recorded as the program asks
  for them (the fake group's fallbacks are below the record);
- the analytic roofline (``core.analytic``), the primary source as in the
  reference, summarized against ``H100_SXM``.

``lower_s`` is the seconds to place the cell, ``compile_s`` the seconds of
its recorded step (the reference's lowering and compiling have no
counterpart).  Results go one JSON file a cell into ``--out`` (default
``build/dryrun``), read by ``repro_torch.benchmarks.roofline_table`` and
``render_experiments``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m \\
        --shape decode_32k [--multi-pod] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

It needs no card and leaves no process group behind.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.capture.flops import eqn_flops
from repro_torch.core import analytic, hlo_analysis

from .cells import all_cells, plan_for
from .mesh import make_production_mesh
from .specs import build_cell, leaves, local_bytes

__all__ = ["run_cell", "record_step", "main", "Recorder", "DEFAULT_OUT"]

DEFAULT_OUT = "build/dryrun"
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd", "c10d")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


class Recorder(TorchDispatchMode):
    """Records every local op of a DTensor program: its FLOPs and bytes,
    each collective's (op, result bytes), and the peak of the live
    intermediates' storages (the storages of ``known`` tensors — the
    step's arguments — are not intermediates)."""

    def __init__(self, known=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.collectives: list[tuple[str, int]] = []
        self._known = {t.untyped_storage()._cdata for t in known}
        self._held: dict[int, tuple[object, int]] = {}
        self.live = 0
        self.peak = 0

    def _sweep(self) -> None:
        dead = [k for k in self._held
                if torch._C._storage_Use_Count(k) <= 1]
        for k in dead:
            self.live -= self._held.pop(k)[1]

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._held:
            return
        self._held[key] = (st, st.nbytes())
        self.live += st.nbytes()

    def __enter__(self):
        # DTensor's sharding propagation runs each new op once on global
        # meta stand-ins to learn its output's shape: not the program's
        # work, so nothing it dispatches is recorded.
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        self._quiet = 0
        self._propagate = ShardingPropagator._propagate_tensor_meta_non_cached
        propagate = self._propagate

        def quiet(prop, *a, **kw):
            self._quiet += 1
            try:
                return propagate(prop, *a, **kw)
            finally:
                self._quiet -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = quiet
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._propagate
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator) or self._quiet:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # let DTensor desugar to local ops
        self._sweep()
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = func._overloadpacket.__name__
            if name in hlo_analysis.COLLECTIVE_NAMES:
                self.collectives.append(
                    (name, sum(_nbytes(t) for t in outs)))
        elif not func.is_view:
            self.n_ops += 1
            self.flops += eqn_flops(func, args, kwargs, out)
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._hold(t)
        self.peak = max(self.peak, self.live)
        return out

    def close(self) -> None:
        self._held.clear()


def _local(tree) -> list[torch.Tensor]:
    from torch.distributed.tensor import DTensor

    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in leaves(tree)]


def record_step(plan, mesh) -> dict:
    """Place ``plan`` on ``mesh`` (a fake-group mesh), run its step once
    under a :class:`Recorder`; returns the entry's measured fields."""
    t0 = time.time()
    fn, args, _, _, _ = build_cell(plan, mesh)
    t_build = time.time() - t0
    arg_bytes = local_bytes(args)
    rec = Recorder(_local(args))
    with warnings.catch_warnings():
        # the fake group's all-to-all fallback and DTensor's advice on
        # flattening mesh dims, once per op
        warnings.simplefilter("ignore")
        with rec:
            out = fn(*args)
    t_run = time.time() - t0 - t_build
    if plan.kind == "train":
        out = (args[0], out)       # the parameters, updated in place
    out_bytes = local_bytes(out)
    rec.close()
    coll = hlo_analysis.collective_stats(rec.collectives)
    return {
        "lower_s": round(t_build, 1),
        "compile_s": round(t_run, 1),
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": rec.peak},
        "hlo_cost_analysis": {"flops": rec.flops,
                              "bytes accessed": rec.bytes},
        "hlo_ops": rec.n_ops,
        "hlo_collective_bytes_per_iter": coll.total_bytes,
        "hlo_collective_by_op": coll.by_op,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False) -> dict:
    plan = plan_for(arch, shape_name)
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        chips = mesh.size()
        model_shards = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
        measured = record_step(plan, mesh)

    tokens = plan.shape.global_batch * (
        plan.shape.seq_len if plan.kind != "decode" else 1)
    model_flops = plan.cfg.model_flops(tokens, training=plan.kind == "train")
    # The analytic model is the primary roofline source, as in the
    # reference; the recorded numbers are kept as the step's evidence.
    data_shards = chips // model_shards
    costs = analytic.cell_cost(
        plan.cfg, plan.shape, kind=plan.kind,
        microbatches=plan.microbatches,
        data_shards=data_shards, model_shards=model_shards,
        infer_fsdp=plan.infer_fsdp,
    )
    rt = hlo_analysis.RooflineTerms(
        name=f"{plan.name}@{'2pod' if multi_pod else '1pod'}",
        chips=chips,
        hlo_flops=costs.flops,
        hlo_bytes=costs.hbm_bytes,
        collective_bytes=costs.collective_bytes,
        model_flops=model_flops,
        hw=hlo_analysis.H100_SXM,
    )
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": plan.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "microbatches": plan.microbatches,
        "status": "ok",
        **measured,
        "tokens": tokens,
        "analytic_notes": {k: float(v) for k, v in costs.notes.items()},
        **rt.summary(),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)

    if args.all:
        cells = [(p.arch, p.shape.name) for p in all_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'2pod' if mp else '1pod'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (exists)")
                continue
            print(f"[run ] {tag} ...", flush=True)
            try:
                entry = run_cell(arch, shape, multi_pod=mp)
            except Exception as e:  # noqa: BLE001
                entry = {
                    "arch": arch, "shape": shape,
                    "mesh": "2x16x16" if mp else "16x16",
                    "status": "error",
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:],
                }
            with open(path, "w") as f:
                json.dump(entry, f, indent=1)
            status = entry["status"]
            extra = ""
            if status == "ok":
                extra = (f" compile={entry['compile_s']}s "
                         f"class={entry['class']} "
                         f"tc={entry['t_compute_s']:.3e} "
                         f"tm={entry['t_memory_s']:.3e} "
                         f"tx={entry['t_collective_s']:.3e}")
            print(f"[done] {tag}: {status}{extra}", flush=True)

    # Note the assignment-mandated skips so the table is complete.
    skips = []
    for arch in configs.ARCHS:
        have = set(configs.shapes_for(arch))
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if shape not in have:
                skips.append({
                    "arch": arch, "shape": shape, "status": "skipped",
                    "reason": "long_500k requires sub-quadratic attention; "
                              "full-attention arch (DESIGN.md §5)",
                })
    with open(os.path.join(args.out, "_skips.json"), "w") as f:
        json.dump(skips, f, indent=1)


if __name__ == "__main__":
    main()
