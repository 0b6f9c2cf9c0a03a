"""recall: of the judged documents that the exact online pipeline drops,
the share the program drops too (the paper's Table 1 protocol)."""


def read(rec):
    j = rec["judge"]
    return j["recall"] if j["exact_dups"] else None
