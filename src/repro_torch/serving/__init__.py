"""``repro_torch.serving`` — production-traffic trace families over the
port's kernels, with phase-aware DAMOV classification (counterpart of
``repro.serving``).

- :mod:`~repro_torch.serving.traffic` — request-arrival / key-popularity
  processes (uniform, Zipfian, hotspot, bursty, sequential, diurnal);
- :mod:`~repro_torch.serving.scenario` — traffic x kernel launches
  (paged-KV decode, MoE dispatch, flash attention) composed through a
  continuous-batching schedule into per-window HBM traces;
- :mod:`~repro_torch.serving.phases` — a DAMOV class verdict per window
  next to the whole-trace label.

``python -m repro_torch.serving`` prints one scenario's phase timeline.
"""

from .phases import MITIGATIONS, PhaseTimeline, measure_windows
from .scenario import (SCENARIOS, ServingScenario, WindowTrace,
                       serving_workloads, window_seed)
from .traffic import (TRAFFIC_FAMILIES, TrafficProcess, WindowDemand,
                      make_traffic)

__all__ = [
    "TRAFFIC_FAMILIES",
    "TrafficProcess",
    "WindowDemand",
    "make_traffic",
    "SCENARIOS",
    "ServingScenario",
    "WindowTrace",
    "serving_workloads",
    "window_seed",
    "MITIGATIONS",
    "PhaseTimeline",
    "measure_windows",
]
