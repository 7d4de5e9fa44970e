"""Wall milliseconds a batch spends in the Eq.-1 pager's calls
(``ServeLoop.stats``' ``pager_s``)."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "serve")
    if recs is None:
        return None
    return 1e3 * sum(r["delta"]["pager_s"] for r in recs) / len(recs)
