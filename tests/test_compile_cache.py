"""Where `import mrt` puts JAX's persistent compilation cache."""

import os
import subprocess
import sys

import pytest

import mrt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_is_fixed_inside_the_checkout():
    assert mrt.CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    assert mrt.compile_cache_dir({}) == mrt.CACHE_DIR
    assert mrt.compile_cache_dir({"JAX_PLATFORMS": "cuda"}) == mrt.CACHE_DIR


def test_env_dir_wins():
    env = {"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}
    assert mrt.compile_cache_dir(env) == "/elsewhere/cache"


@pytest.mark.parametrize("env", [{"JAX_PLATFORMS": "cpu"},
                                 {"JAX_PLATFORMS": "CPU"},
                                 {"MRT_NO_COMPILE_CACHE": "1"}])
def test_opt_outs(env):
    assert mrt.compile_cache_dir(env) is None


def _configured_dir(env_updates):
    """jax_compilation_cache_dir after `import mrt` in a fresh process
    (no device is opened: only the config is read)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "MRT_NO_COMPILE_CACHE")}
    env.update(env_updates)
    out = subprocess.run(
        [sys.executable, "-c",
         "import mrt, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def test_import_sets_checkout_dir_when_env_unset():
    assert _configured_dir({}) == os.path.join(ROOT, ".jax_cache")


def test_import_keeps_env_dir(tmp_path):
    d = str(tmp_path / "cache")
    assert _configured_dir({"JAX_COMPILATION_CACHE_DIR": d}) == d


def test_import_on_cpu_sets_nothing():
    assert _configured_dir({"JAX_PLATFORMS": "cpu"}) == "None"
