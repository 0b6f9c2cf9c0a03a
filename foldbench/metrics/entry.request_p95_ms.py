"""entry.request_p95_ms: 95th percentile, over every request due in the
window, of the time from its scheduled arrival to the verdict of its last
document (open loop). A per-layer metric: the host's speed moves it by
more than an end-to-end bound may hold (`PERF.md` section 2)."""

import numpy as np


def read(rec):
    lat = rec.get("latency_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
