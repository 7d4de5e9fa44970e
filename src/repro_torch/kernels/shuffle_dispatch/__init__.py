from .ops import combine, compute_slots, dispatch, host_dispatch_plan
from .ref import combine_ref, dispatch_ref

__all__ = ["combine", "combine_ref", "compute_slots", "dispatch",
           "dispatch_ref", "host_dispatch_plan"]
