"""All model FLOPs of the window (real prompt tokens, every decode step)
over its wall time, as a share of 989 TFLOP/s bf16."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "serve")
    if recs is None:
        return None
    flops = sum(sum(readers.prefill_flops(run, L) for L in r["prompt_lens"])
                + readers.decode_flops(run, r) for r in recs)
    return readers.mfu(flops, recs[-1]["t_done"] - recs[0]["t_send"])
