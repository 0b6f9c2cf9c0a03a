"""device.ops_per_batch: the host's calls that enqueue a device operation
(a launch per kernel, a copy or set call per memcpy or memset) over the
traced batches, per batch."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["units"]:
        return None
    return tr["device_ops"] / tr["units"]
