"""The MoE shuffle kernels' share of their roofline in the train calls,
in %: dispatch's and combine's bounds (only the rows this routing selects)
over their device time."""
from perfbench import readers


def read(run):
    return readers.roofline(run, "train", "pb.shuffle.train")
