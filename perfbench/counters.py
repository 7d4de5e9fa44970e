"""The port's counters (``repro_torch.trace.counters``) as a run left
them, for the metric readers: read once the run is over, which syncs with
the device. A port without counters, or a run that is not training,
gives an empty dict."""
from __future__ import annotations

from typing import Dict


def of(run) -> Dict[str, float]:
    from repro_torch import trace
    read = getattr(trace, "counters", None)
    return read() if read is not None and run.kind == "train" else {}
