from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention"]
