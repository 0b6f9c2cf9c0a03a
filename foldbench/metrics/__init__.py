"""One reader per metric, `<name>.py`, each a `read(rec)` that returns the
metric's value, or None where the run holds nothing for it to read."""
