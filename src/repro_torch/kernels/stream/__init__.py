from . import capture, ref  # noqa: F401
from .kernel import stream_cuda  # noqa: F401
from .ops import (  # noqa: F401
    bytes_moved,
    stream_add,
    stream_copy,
    stream_scale,
    stream_triad,
)
