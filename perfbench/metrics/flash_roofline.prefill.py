"""flash_attention's share of its roofline in the prefill calls, in %: the
calls' bounds (q, k, v read and the output written once, 2 D + 2 Dv flops
a live causal pair and head) over their device time."""
from perfbench import readers


def read(run):
    return readers.roofline(run, "serve", "pb.flash.prefill")
