import os
import sys

# Tests run on the single real CPU device (the 512-device override is ONLY
# for launch/dryrun.py, which sets it before importing jax in its own
# process). Keep pallas kernels in interpret mode here.
os.environ.setdefault("REPRO_PALLAS_INTERPRET", "1")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Offline containers have no hypothesis wheel; fall back to the vendored
# API-compatible shim (deterministic seeded sweeps, no shrinking). A real
# install (requirements.txt) always takes precedence.
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "_vendor"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason without one")
