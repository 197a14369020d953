from .kernel import window_count_cuda  # noqa: F401
from .ops import record, scan, to_device, window_counts  # noqa: F401
from .plan import window_plan  # noqa: F401
from .ref import window_counts_ref  # noqa: F401
