import os

# smoke tests and benches must see ONE device; only launch/dryrun.py sets
# the 512-device flag (before any jax import) — never set it here.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one (on the "
        "card: python -m pytest -m gpu tests/test_torch_gpu.py)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
