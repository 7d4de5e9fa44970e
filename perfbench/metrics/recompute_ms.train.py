"""Device milliseconds a step in the remat recompute: the kernels under a
``pangea.layer`` span opened while ``pangea.step.backward`` is open."""
from perfbench import spans


def read(run):
    s = spans.of(run)
    return spans.ms_per_step(run, s and s.recompute_s)
