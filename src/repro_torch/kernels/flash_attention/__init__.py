from . import capture  # noqa: F401
from .kernel import flash_attention_cuda  # noqa: F401
from .ops import flash_attention, mha  # noqa: F401
from .ref import attention_ref  # noqa: F401
