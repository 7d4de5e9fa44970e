"""Device milliseconds a step in attention's backward (autograd's
``_FlashAttentionBackward`` nodes, the plain mirror of the reference's
VJP)."""
from perfbench import readers


def read(run):
    return readers.range_ms_per(run, "train", "pb.attn_bwd")
