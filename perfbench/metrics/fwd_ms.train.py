"""Device milliseconds a step in the train step's forward (the port's span
``pangea.step.forward``: compute cast, layers, logits, loss), inclusive of
the layers and kernel entries inside it."""
from perfbench import spans


def read(run):
    s = spans.of(run)
    return spans.ms_per_step(run, s and s.phase_s.get("pangea.step.forward"))
