"""request_p95_ms: 95th percentile, over every request due in the window,
of the time from its scheduled arrival to the verdict of its last
document (open loop)."""

import numpy as np


def read(rec):
    lat = rec.get("latency_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
