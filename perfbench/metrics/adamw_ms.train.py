"""Device milliseconds a step in the optimizer's update (``adamw_apply``,
range ``pb.adamw`` of the trace)."""
from perfbench import readers


def read(run):
    return readers.range_ms_per(run, "train", "pb.adamw")
