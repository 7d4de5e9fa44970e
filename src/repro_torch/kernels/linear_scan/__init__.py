from .ops import gla_scan
from .ref import gla_scan_ref

__all__ = ["gla_scan", "gla_scan_ref"]
