from . import capture  # noqa: F401
from .kernel import ssm_chunked_cuda, ssm_ema_cuda  # noqa: F401
from .ops import ssm_chunked_scan, ssm_ema_scan  # noqa: F401
from .ref import ssm_chunked_ref, ssm_ema_ref  # noqa: F401
