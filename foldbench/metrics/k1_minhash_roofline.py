"""k1_minhash_roofline: K1's least time at the traced batches' shapes
(`roofline/k1_minhash.py`) over its event time in the trace, in percent."""

from foldbench.metrics import _roofline
from foldbench.roofline import k1_minhash


def _work(fold, s):
    return k1_minhash.work(s["B"], s["L"], fold["num_hashes"],
                           s["valid_shingles"])


def read(rec):
    return _roofline.share(rec, k1_minhash.TRACE_NAME, _work)
