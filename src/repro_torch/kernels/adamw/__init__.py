from .ops import adamw, bias_corrections
from .ref import adamw_ref

__all__ = ["adamw", "adamw_ref", "bias_corrections"]
