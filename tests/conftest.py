import os

# Keep the default device count at 1 for smoke tests / benches; distributed
# tests that need fake devices spawn subprocesses with their own XLA_FLAGS.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped with a reason where none is present"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# Paper Table 1 database: a=0 b=1 c=2 d=3 e=4 f=5 g=6
PAPER_TX = [[0, 1, 6], [1, 2, 3, 5, 6], [0, 1, 4], [0, 3], [1, 2, 4], [0, 3, 4, 5], [1, 2]]


@pytest.fixture
def paper_db():
    from repro.core.encoding import pad_transactions

    return pad_transactions(PAPER_TX), 7
