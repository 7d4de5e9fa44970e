"""Seconds from the process's start to the first timed request or step:
imports, weights, the port's set-up, the warm-up (and, in a run that
builds, the build); work that only the check needs before the window
(the training cells' host copy of the first gradients) left out."""


def read(run):
    return run.setup_s
