from . import capture  # noqa: F401
from .kernel import gather_rows_cuda  # noqa: F401
from .ops import gather, gather_rows  # noqa: F401
from .ref import gather_rows_ref  # noqa: F401
