from .ops import paged_attention
from .ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_ref"]
