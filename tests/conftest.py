import os
import sys

# Make `pytest tests/` work without PYTHONPATH=src (and never set XLA device
# flags here — smoke tests must see exactly 1 CPU device; the dry-run tests
# spawn subprocesses with their own DRYRUN_DEVICES).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Offline fallback: if the real `hypothesis` package is missing, expose the
# vendored minimal implementation (repro/_vendor/hypothesis) so the
# property-test modules still collect and run.  An installed hypothesis
# always takes precedence because the vendor dir is only added on failure.
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src",
                                    "repro", "_vendor"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (large-fleet smokes); deselect with "
        "-m 'not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (kernel against its plain version); "
        "skips where torch.cuda.is_available() is False")
