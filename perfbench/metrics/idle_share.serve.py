"""Share of the traced window, in %, in which no operation ran on the
device."""
from perfbench import readers


def read(run):
    return readers.idle_share(run, "serve")
