"""device.idle_share.service: the idle share (`_idle.py`) over the traced
segment of an open loop."""

from foldbench.metrics._idle import read  # noqa: F401
