"""Shared by the kernel roofline readers: the share of the least time
(`roofline/peaks.py`) in the measured kernel time, summed over the traced
batches, in percent. None where the trace does not hold one event of the
kernel per traced batch."""

from foldbench.roofline import peaks


def share(rec, trace_name, work):
    tr = rec.get("trace")
    if not tr or not tr.get("shapes"):
        return None
    durs = [d for name, ds in tr["kernels"].items() if trace_name in name
            for d in ds]
    if len(durs) != len(tr["shapes"]) or sum(durs) <= 0:
        return None
    least = sum(peaks.least_seconds(*work(rec["fold"], s))
                for s in tr["shapes"])
    return least / sum(durs) * 100.0
