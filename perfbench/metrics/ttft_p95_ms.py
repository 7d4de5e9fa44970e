"""95th percentile, over every request completed in the window, of the
time from its send (its batch's start: 8 clients in a closed loop) to its
first token on the host."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "serve")
    if recs is None:
        return None
    ttft = [r["t_first"] - r["t_send"] for r in recs
            for _ in r["prompt_lens"]]
    return 1e3 * readers.percentile(ttft, 95)
