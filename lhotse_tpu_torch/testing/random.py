"""
Deterministic RNG pytest fixture (copied from
``lhotse_tpu/testing/random.py``): seeds numpy and the standard library's
``random``, the RNGs of the host data path, as the JAX package's does.
"""
import random

import numpy as np
import pytest


@pytest.fixture
def deterministic_rng(request):
    """
    Seed numpy + stdlib RNGs for the duration of a test, restoring the
    previous state afterwards. Customize the seed with
    ``@pytest.mark.seed(1337)``.
    """
    marker = request.node.get_closest_marker("seed")
    SEED = 0 if marker is None else marker.args[0]

    np_state = np.random.get_state()
    py_state = random.getstate()

    np.random.seed(SEED)
    random.seed(SEED)

    yield SEED

    random.setstate(py_state)
    np.random.set_state(np_state)
