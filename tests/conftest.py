import os
import sys

# Tests run on the single real CPU device (the 512-device override is ONLY for
# repro.launch.dryrun, which sets XLA_FLAGS before importing jax in its own
# process).  Keep compilation single-threaded-ish and quiet.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# Make the optional-hypothesis shim (tests/hypcompat.py) importable from any
# test module regardless of pytest's rootdir/package resolution.
sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skipped where torch.cuda.is_available() is False",
    )
