from . import capture  # noqa: F401
from .kernel import ssm_chunked_cuda, ssm_ema_cuda  # noqa: F401
from .ops import (chunked_scan, ema_scan, ssm_chunked_scan,  # noqa: F401
                  ssm_ema_scan)
from .ref import ssm_chunked_ref, ssm_ema_ref  # noqa: F401
