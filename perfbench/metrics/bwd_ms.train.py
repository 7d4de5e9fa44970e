"""Device milliseconds a step in the train step's backward (the port's span
``pangea.step.backward``, ``torch.autograd.grad``): every kernel launched
while it is open, on autograd's device thread too, the remat recompute
included."""
from perfbench import spans


def read(run):
    s = spans.of(run)
    return spans.ms_per_step(run, s and s.phase_s.get("pangea.step.backward"))
