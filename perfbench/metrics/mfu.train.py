"""Model FLOPs of the window's steps (6 x active matmul weights x tokens
plus three times the causal attention's), recomputation not counted, over
the window's wall time, as a share of 989 TFLOP/s bf16."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "train")
    if recs is None:
        return None
    flops = sum(readers.train_flops(run, r) for r in recs)
    return readers.mfu(flops, recs[-1]["t_end"] - recs[0]["t_start"])
