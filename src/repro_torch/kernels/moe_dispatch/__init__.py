from . import capture  # noqa: F401
from .kernel import moe_grouped_gemm  # noqa: F401
from .ops import moe_dispatch, moe_dispatch_sorted  # noqa: F401
from .ref import moe_dispatch_ref, moe_dispatch_sorted_ref  # noqa: F401
