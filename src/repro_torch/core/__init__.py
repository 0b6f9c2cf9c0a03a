"""Core algorithms of the port (counterpart of `repro.core`)."""
