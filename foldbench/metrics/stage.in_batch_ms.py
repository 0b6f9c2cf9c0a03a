"""stage.in_batch_ms: the program's own t_in_batch timer of `process_batch`
(each stage ends in a device synchronisation), summed over the window's
batches and divided by their number."""


def read(rec):
    stages = rec.get("stages")
    if not stages:
        return None
    return sum(s["t_in_batch"] for s in stages) / len(stages) * 1e3
