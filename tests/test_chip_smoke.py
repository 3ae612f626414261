"""chip_smoke.py's device check and comparison rule (on the CPU)."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest

import chip_smoke
from mrt.utils.device import require_gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device()


def test_device_check_accepts_gpu():
    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    assert require_gpu([FakeGpu()]) == ("gpu", "NVIDIA H100 80GB HBM3", 1)


def test_script_fails_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    for line in r.stdout.splitlines():   # no result line
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_compare_share_rule():
    ref = np.ones((100, 3), np.float32)
    got = ref.copy()
    got[:2] = 1.3                        # two pixels flipped
    assert chip_smoke.compare("x", got, ref, min_share=0.98) == 0.98
    with pytest.raises(AssertionError, match="within tolerance"):
        chip_smoke.compare("x", got, ref, min_share=0.99)
    depth = np.arange(50)
    assert chip_smoke.compare("d", depth, depth, min_share=1.0) == 1.0


def test_compare_mean_rule():
    ref = np.ones((100, 3), np.float32)
    got = ref * 1.005                    # every pixel within 1e-2
    assert chip_smoke.compare("x", got, ref) == 1.0
    with pytest.raises(AssertionError, match="mean off"):
        chip_smoke.compare("x", got, ref, mean_rtol=1e-3)
