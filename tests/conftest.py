"""Test harness configuration.

Tests run on the CPU with a virtual 8-device mesh (SURVEY §4):
hermetic, and enough devices to exercise the shard_map tile/spp
sharding logic under pytest.  Code that needs the card runs through
`chip_smoke.py` on the GPU.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
