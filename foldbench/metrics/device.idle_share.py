"""device.idle_share: the idle share (`_idle.py`) over the traced batches
of a closed loop."""

from foldbench.metrics._idle import read  # noqa: F401
