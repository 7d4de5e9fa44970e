"""Wall milliseconds a batch's prefill takes, from ``ServeLoop.stats``'
``prefill_s`` (the model's prefill and the first argmax on the host)."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "serve")
    if recs is None:
        return None
    return 1e3 * sum(r["delta"]["prefill_s"] for r in recs) / len(recs)
