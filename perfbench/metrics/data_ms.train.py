"""Host milliseconds a step spends outside the train step: the batch's
fetch from the ``BatchLoader`` and ``train_batch``'s move to the card."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "train")
    if recs is None:
        return None
    return 1e3 * sum(r["t_step"] - r["t_start"] for r in recs) / len(recs)
