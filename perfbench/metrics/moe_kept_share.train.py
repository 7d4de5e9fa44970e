"""Share of the pairs routed to the experts held on this chip that their
experts took, under capacity, in %: the port's counters moe.pairs_kept
over moe.pairs_held (``repro_torch.trace``), summed over the run's
training forwards, remat recomputes not counted. Nothing where the port
keeps no such counters."""
from perfbench import counters


def read(run):
    c = counters.of(run)
    if not c.get("moe.pairs_held"):
        return None
    return 100.0 * c["moe.pairs_kept"] / c["moe.pairs_held"]
