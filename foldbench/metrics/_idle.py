"""The idle share of a traced segment: 1 - busy / wall, busy being the
union of the device's operation intervals."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
