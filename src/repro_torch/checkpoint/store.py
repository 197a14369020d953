"""Atomic, async checkpointing in the reference's on-disk layout.

The port of ``repro.checkpoint.store``.  One directory per step::

    <dir>/step_00000123/
        manifest.json        # tree structure, dtypes, shapes, step
        <leafpath>.npy       # one file per leaf
        COMMIT               # written LAST -> crash-consistent marker

- **atomicity**: data lands in ``step_X.tmp`` and is renamed only after
  the COMMIT marker is in place; a killed writer never corrupts the
  latest step.
- **restart**: ``latest_step()`` finds the newest committed step.
- **async**: ``CheckpointManager(async_save=True)`` copies every leaf to
  host memory, then writes on a background thread while training goes on.
- **retention**: the ``keep`` newest checkpoints stay, the rest go.
- **on a mesh**: leaves are global (``train.step.train_tree`` gathers each
  DTensor first), and rank 0 alone writes, commits and collects; every
  rank meets a barrier before the next save, at ``wait`` and before
  ``latest_step``, so none reads a step rank 0 is still writing.
- **elastic restore**: ``load_checkpoint(shardings=...)`` places each leaf
  onto a mesh, each rank reading the memory-mapped ``.npy`` for its own
  shard alone (``local_slice``), so a checkpoint written on any mesh (or
  none, or by the reference) restores onto any other.

Leaves are torch tensors (on any device), numpy arrays or numbers.
numpy has no bfloat16 (the reference reaches for ``ml_dtypes``): bf16 and
float8 leaves are stored as unsigned ints of their width, viewed bit for
bit (``tensor.view(torch.int16)``), with their dtype named in the
manifest, so either package reads what the other wrote.  ``load`` returns
torch tensors, on ``device`` when one is given.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager", "local_slice"]

_COMMIT = "COMMIT"

# dtypes numpy cannot hold: stored as same-width unsigned ints
_EXTENDED = {"bfloat16": torch.bfloat16,
             "float8_e4m3fn": torch.float8_e4m3fn,
             "float8_e5m2": torch.float8_e5m2}
# width -> (torch's signed view, numpy's signed view, the stored dtype)
_INT_OF_WIDTH = {1: (torch.int8, np.int8, np.uint8),
                 2: (torch.int16, np.int16, np.uint16)}
_NAME_OF = {v: k for k, v in _EXTENDED.items()}


def _flatten(tree: Any) -> dict[str, Any]:
    flat = {}

    def walk(prefix: str, node: Any):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _unflatten(flat: dict[str, Any], manifest: dict) -> Any:
    tree: Any = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def fix(node, spec):
        if isinstance(spec, dict) and spec.get("__kind__") == "list":
            return [fix(node[str(i)], spec[str(i)])
                    for i in range(spec["__len__"])]
        if isinstance(spec, dict) and "__kind__" not in spec:
            return {k: fix(node[k], spec[k]) for k in spec}
        return node

    return fix(tree, manifest["structure"])


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = {str(i): _structure(v) for i, v in enumerate(tree)}
        out["__kind__"] = "list"
        out["__len__"] = len(tree)
        return out
    return None


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """(the array written, the dtype named in the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _NAME_OF:
            as_int, _, stored = _INT_OF_WIDTH[t.element_size()]
            return t.view(as_int).numpy().view(stored), _NAME_OF[t.dtype]
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_host(leaf: Any) -> Any:
    """A copy in host memory that nothing else holds."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Atomic synchronous save. Returns the final step dir."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    meta = {}
    for path, leaf in _flatten(tree).items():
        arr, dtype_name = _to_numpy(leaf)
        np.save(os.path.join(tmp, path.replace("/", ".") + ".npy"), arr)
        meta[path] = {"shape": list(arr.shape), "dtype": dtype_name}

    manifest = {"step": step, "leaves": meta, "structure": _structure(tree)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _COMMIT)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _multi_rank() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _rank() -> int:
    return dist.get_rank() if _multi_rank() else 0


def local_slice(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of the global tensor ``full`` under
    ``placements`` on ``mesh``, as a view of it (a memory-mapped leaf is
    read for these rows alone)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        full.shape, mesh, placements)
    return full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def _placed(full: torch.Tensor, ns) -> torch.Tensor:
    """``full`` placed by ``ns`` (a ``models.sharding.NamedSharding``):
    a DTensor whose local tensor is this rank's slice, copied to the
    mesh's device."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.shard_ops import contiguous_stride
    from repro_torch.models.sharding import mesh_device

    mesh, pl = ns.mesh, ns.placements
    local = local_slice(full, mesh, pl).to(mesh_device(mesh), copy=True)
    shape = tuple(full.shape)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def load_checkpoint(directory: str, step: int | None = None, *,
                    device: str | torch.device | None = None,
                    shardings: Any = None, mmap: bool = False
                    ) -> tuple[int, Any]:
    """Load (by default the latest) committed checkpoint as torch tensors,
    moved to ``device`` when one is given.  ``shardings``, a matching tree
    of ``models.sharding.NamedSharding``, places each leaf onto its mesh
    instead (the reference's elastic restore): every rank memory-maps the
    ``.npy`` and keeps its own shard.  ``mmap`` leaves the leaves in host
    memory, memory-mapped (copy on write), for a caller that slices
    them."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    lazy = mmap or shardings is not None
    for path, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(d, path.replace("/", ".") + ".npy"),
                      mmap_mode="c" if lazy else None)
        if meta["dtype"] in _EXTENDED:
            _, np_int, _ = _INT_OF_WIDTH[arr.dtype.itemsize]
            t = torch.from_numpy(arr.view(np_int)).view(
                _EXTENDED[meta["dtype"]])
        else:
            t = torch.from_numpy(arr)
        flat[path] = t if device is None or lazy else t.to(device)
    tree = _unflatten(flat, manifest)
    if shardings is not None:
        tree = _zip_map(_placed, tree, shardings)
    return step, tree


class CheckpointManager:
    """Retention + async writes on top of save/load."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any) -> None:
        """Save ``tree`` (global leaves) as ``step``; on a mesh every rank
        calls it, rank 0 alone writes."""
        self.wait()
        if _rank() != 0:
            return
        if self.async_save:
            host_tree = _map(_to_host, tree)
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host_tree), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, tree)

    def _save_and_gc(self, step: int, tree: Any) -> None:
        save_checkpoint(self.directory, step, tree)
        self._gc()

    def wait(self) -> None:
        """The last save is committed, on every rank (a barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _multi_rank():
            dist.barrier()

    def restore_latest(self, device: str | torch.device | None = None, *,
                       shardings: Any = None, mmap: bool = False):
        self.wait()
        return load_checkpoint(self.directory, device=device,
                               shardings=shardings, mmap=mmap)

    def latest_step(self) -> int | None:
        self.wait()
        return latest_step(self.directory)

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.directory, n, _COMMIT))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


def _zip_map(fn, tree: Any, other: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)
