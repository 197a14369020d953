"""Production meshes (the port of ``repro.launch.mesh``), on torch's
``DeviceMesh``.

Single pod: 16 x 16 = 256 cards, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 cards, axes ("pod", "data", "model") — the
"pod" axis carries data parallelism across pods and joins "data" for FSDP
weight sharding.

The production meshes are planned, not run: :func:`make_production_mesh`
builds one over torch's fake process group (one process plays rank 0 of
512; every collective returns without moving data), which the dry run
drives with ``meta`` tensors.  :func:`make_local_mesh` builds one over the
cards that exist.  Both are context managers: the process group they
initialize is destroyed when the block ends, since other code reads
``torch.distributed``'s world size and rank whenever a group is up
(``repro_torch.data.pipeline.SyntheticTokens``).
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_local_mesh", "make_abstract_mesh",
           "fake_mesh", "AbstractMesh", "PRODUCTION_SHAPES"]

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


class AbstractMesh:
    """A device-free mesh for resolving shardings (tests, planning): the
    reference's ``.shape`` mapping {axis: size} and its axis names, with
    no process group."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"{shape} and {axes} differ in length")
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def make_abstract_mesh(shape: tuple[int, ...],
                       axes: tuple[str, ...]) -> AbstractMesh:
    return AbstractMesh(tuple(shape), tuple(axes))


@contextlib.contextmanager
def _group(backend: str, world_size: int, store) -> Iterator[None]:
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialized; the mesh would "
            "replace it")
    dist.init_process_group(backend, rank=0, world_size=world_size,
                            store=store)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """``with fake_mesh(shape, axes) as mesh``: a ``DeviceMesh`` of that
    shape over a fake process group, as rank 0.  Refuses while another
    group is up."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for n in shape:
        world *= n
    with _group("fake", world, FakeStore()):
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """``with make_production_mesh() as mesh``: the 16x16 (or 2x16x16)
    production mesh over a fake process group (:func:`fake_mesh`)."""
    return fake_mesh(*PRODUCTION_SHAPES[multi_pod])


@contextlib.contextmanager
def make_local_mesh(model_axis: int = 1, device: str = "cuda"):
    """``with make_local_mesh() as mesh``: a ("data", "model") mesh over
    the cards that exist.  Under a launcher (a group already up) it uses
    the group's ranks and leaves the group alone; otherwise it initializes
    a one-rank group over a ``HashStore`` — NCCL on ``cuda`` (which must
    exist), gloo for ``device="cpu"`` — and destroys it on exit."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    own = not dist.is_initialized()
    with (_group("nccl" if dev.type == "cuda" else "gloo", 1,
                 dist.HashStore()) if own else contextlib.nullcontext()):
        n = dist.get_world_size()
        if n % model_axis:
            raise ValueError(f"{n} ranks do not split into a model axis "
                             f"of {model_axis}")
        if dev.type == "cuda":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        yield init_device_mesh(dev.type, (n // model_axis, model_axis),
                               mesh_dim_names=("data", "model"))
