"""Model FLOPs of the real prompt tokens over the prefills' wall time
(``ServeLoop.stats``' ``prefill_s``), as a share of 989 TFLOP/s bf16."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "serve")
    if recs is None:
        return None
    flops = sum(readers.prefill_flops(run, L) for r in recs
                for L in r["prompt_lens"])
    return readers.mfu(flops, sum(r["delta"]["prefill_s"] for r in recs))
