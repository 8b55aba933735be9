"""Test configuration: the tests run on the CPU with 8 virtual devices.

The platform and device count are pinned through ``jax.config`` before any
backend is initialized, so the tests never touch an accelerator, even on a
machine that has one.  The 8 virtual devices back the multi-device sharding
tests (SURVEY.md §4 item 5).  What only the card can show is checked by
``chip_smoke.py``.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
