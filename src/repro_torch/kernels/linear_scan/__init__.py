from .ops import diag_scan, gla_scan
from .ref import diag_scan_ref, gla_scan_ref

__all__ = ["diag_scan", "diag_scan_ref", "gla_scan", "gla_scan_ref"]
