from .kernel import window_count_cuda  # noqa: F401
from .ops import record, to_device, window_counts  # noqa: F401
from .ref import window_counts_ref  # noqa: F401
