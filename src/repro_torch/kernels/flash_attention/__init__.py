from . import capture  # noqa: F401
from .kernel import flash_attention  # noqa: F401
from .ops import mha  # noqa: F401
from .ref import attention_ref  # noqa: F401
