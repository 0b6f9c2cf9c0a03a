"""Tests of the benchmark, run on the CPU with the rest of the suite
(`python -m pytest`); those that need a card are marked `gpu`."""
import os
import sys

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    "src"))
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
