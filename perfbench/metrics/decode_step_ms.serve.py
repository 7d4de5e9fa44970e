"""Wall milliseconds a decode step takes, from ``ServeLoop.stats``'
``decode_s`` (the step loop, the pager's calls in it) over the steps."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "serve")
    if recs is None:
        return None
    return 1e3 * (sum(r["delta"]["decode_s"] for r in recs)
                  / sum(r["steps"] for r in recs))
