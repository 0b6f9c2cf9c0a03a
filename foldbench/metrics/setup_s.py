"""setup_s: process start to the first timed unit of work (imports, the
card's start, building or restoring the prefill, the warm-up unit)."""


def read(rec):
    return rec["setup_s"]
