"""docs_per_s: every document of the batches completed in the window, over
the time from the window's start to the last completion (closed loop)."""


def read(rec):
    done = rec.get("done")
    if not done:
        return None
    return sum(rec["docs"]) / (done[-1] - rec["window_start"])
