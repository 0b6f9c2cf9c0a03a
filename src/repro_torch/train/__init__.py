"""Training-side modules of the port: the checkpoint layout
(`checkpoint`) and the loss, prefill and decode steps (`step`)."""
