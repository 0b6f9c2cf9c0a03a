"""k2_jaccard_roofline: K2's least time at the traced batches' shapes
(`roofline/k2_jaccard.py`; the in-batch matrix, Q = N = B) over its event
time in the trace, in percent."""

from foldbench.metrics import _roofline
from foldbench.roofline import k2_jaccard


def _work(fold, s):
    return k2_jaccard.work(s["B"], s["B"], fold["T"] // 32)


def read(rec):
    return _roofline.share(rec, k2_jaccard.TRACE_NAME, _work)
