"""Host milliseconds a step inside the port's train step (``pangea.step``,
entry to return), from the untraced half's records: beside the step's wall
time it says whether the host paces the step."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "train")
    if recs is None or any(r.get("step_host_s") is None for r in recs):
        return None
    return 1e3 * sum(r["step_host_s"] for r in recs) / len(recs)
