from . import capture  # noqa: F401
from .kernel import paged_decode_attention  # noqa: F401
from .ops import paged_decode  # noqa: F401
from .ref import paged_decode_ref  # noqa: F401
