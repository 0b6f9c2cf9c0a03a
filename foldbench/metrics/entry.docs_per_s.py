"""entry.docs_per_s: every document of the batches completed in the
window, over the time from the window's start to the last completion
(closed loop). A per-layer metric: the host's speed moves it by more than
an end-to-end bound may hold (`PERF.md` section 2)."""


def read(rec):
    done = rec.get("done")
    if not done:
        return None
    return sum(rec["docs"]) / (done[-1] - rec["window_start"])
