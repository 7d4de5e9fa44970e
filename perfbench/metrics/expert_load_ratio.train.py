"""The most-loaded held expert's pairs over the mean held expert's, a
layer and a training forward (where the held experts got pairs),
averaged: the port's counters
moe.load_ratio_sum over moe.load_ratio_n (``repro_torch.trace``); 1 is an
even load. Nothing where the port keeps no such counters."""
from perfbench import counters


def read(run):
    c = counters.of(run)
    if not c.get("moe.load_ratio_n"):
        return None
    return c["moe.load_ratio_sum"] / c["moe.load_ratio_n"]
