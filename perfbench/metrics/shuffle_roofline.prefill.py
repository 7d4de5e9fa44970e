"""The MoE shuffle kernels' share of their roofline in the prefill calls,
in %: dispatch's and combine's bounds (only the rows this routing selects)
over their device time."""
from perfbench import readers


def read(run):
    return readers.roofline(run, "serve", "pb.shuffle.prefill")
