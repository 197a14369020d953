from . import capture  # noqa: F401
from .kernel import gather_rows  # noqa: F401
from .ops import gather  # noqa: F401
from .ref import gather_rows_ref  # noqa: F401
