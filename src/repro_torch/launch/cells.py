"""Per-(arch x shape) execution plans: what to run, with which knobs.

The dry-run and the roofline/benchmark layers share this table.  A *cell*
is one (architecture, input-shape) pair; its plan carries the memory knobs
(microbatches, remat) of the reference's ``repro.launch.cells``, which
chose them for its production mesh; the port keeps them as they are, so
its cells and their analytic costs equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import configs
from ..models.config import SHAPES, ModelConfig, ShapeSpec

__all__ = ["CellPlan", "plan_for", "all_cells"]


@dataclass(frozen=True)
class CellPlan:
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    microbatches: int = 1
    kind: str = "train"        # train | prefill | decode
    # sharding-rule overrides for this cell (e.g. nemotron keeps FSDP
    # weight sharding at inference: 680 GB of bf16 weights cannot sit
    # model-sharded-only on 16 chips' HBM)
    rules_override: tuple = ()

    @property
    def name(self) -> str:
        return f"{self.arch}:{self.shape.name}"

    @property
    def infer_fsdp(self) -> bool:
        return dict(self.rules_override).get("fsdp") is not None


# Memory knobs per (arch, shape). Defaults: microbatches=1.
# nemotron-4-340b train: 1M tokens x d_model 18432 saved residuals need
# sequential accumulation to fit; ditto the larger dense models.
_MICROBATCHES: dict[tuple[str, str], int] = {
    ("nemotron-4-340b", "train_4k"): 16,
    ("qwen2.5-14b", "train_4k"): 4,
    ("granite-20b", "train_4k"): 4,
    ("phi4-mini-3.8b", "train_4k"): 2,
    ("zamba2-7b", "train_4k"): 4,
    ("deepseek-moe-16b", "train_4k"): 2,
    ("deepseek-v2-lite-16b", "train_4k"): 2,
    ("whisper-large-v3", "train_4k"): 2,
    ("paligemma-3b", "train_4k"): 2,
}


def plan_for(arch: str, shape_name: str) -> CellPlan:
    shape = SHAPES[shape_name]
    cfg = configs.get(arch)
    mb = _MICROBATCHES.get((arch, shape_name), 1)
    override: tuple = ()
    if arch == "nemotron-4-340b" and shape.kind != "train":
        # 340B bf16 weights exceed model-axis-only HBM; keep 2D sharding
        # and pay the per-step weight all-gather (documented in §Roofline).
        override = (("fsdp", ("pod", "data")),)
    return CellPlan(arch=arch, shape=shape, cfg=cfg, microbatches=mb,
                    kind=shape.kind, rules_override=override)


def all_cells() -> list[CellPlan]:
    out = []
    for arch in configs.ARCHS:
        for shape_name in configs.shapes_for(arch):
            out.append(plan_for(arch, shape_name))
    return out
