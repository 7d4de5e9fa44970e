"""Real prompt tokens plus returned tokens of the batches completed in
the window, over the time from the first batch's send to the last one's
end. Padding is not counted."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "serve")
    if recs is None:
        return None
    tokens = sum(sum(r["prompt_lens"]) + sum(r["returned"]) for r in recs)
    return tokens / (recs[-1]["t_done"] - recs[0]["t_send"])
