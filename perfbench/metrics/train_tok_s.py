"""Tokens of the training steps completed in the window over the time
from the first timed step's start (its batch's fetch) to the last one's
end (its loss on the host). The set-up's steps are not counted."""
from perfbench import readers


def read(run):
    recs = readers.records(run, "train")
    if recs is None:
        return None
    return sum(r["tokens"] for r in recs) / (recs[-1]["t_end"]
                                             - recs[0]["t_start"])
