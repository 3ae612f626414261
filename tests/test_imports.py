"""What the package needs at import and which switches it reads.

The render path runs on a machine where only JAX and a few numeric
packages are sure to exist, so importing every module of `mrt` must
pull in no Pallas, no flax and no imaging library; and the switches of
removed code paths must not be read anywhere.
"""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mrt")

REMOVED_SWITCHES = [
    "MRT_PALLAS", "MRT_SPHERE_KERNEL", "MRT_BLOCK_ROWS", "MRT_ORDERED",
    "MRT_STREAM_BLOCK_ROWS", "MRT_ONEHOT", "MRT_ONEHOT_BP",
    "MRT_ONEHOT_F32", "MRT_FILM_MM", "MRT_FILM_MM_W", "MRT_FILM_MM_L",
    "MRT_FILM_MM_K", "MRT_FILM_SKIP", "MRT_MM_NORING",
    "MRT_MM_NOCONFLICT", "MRT_FILM_PEND", "MRT_TEX_COMPACT",
    "MRT_BG_COMPACT", "MRT_NO_ROWMM", "MRT_COMPILE_CACHE_DIR",
]


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    yield path, fh.read()


def test_no_pallas_in_sources():
    pat = re.compile(r"jax\.experimental\.pallas|pallas_call")
    bad = [p for p, src in _sources() if pat.search(src)]
    assert not bad, bad


def test_importing_everything_loads_no_optional_package():
    code = (
        "import pkgutil, importlib, sys, mrt\n"
        "for m in pkgutil.walk_packages(mrt.__path__, 'mrt.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('flax', 'PIL') or k.startswith('jax.experimental.pallas'))\n"
        "print(bad)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.mark.parametrize("name", REMOVED_SWITCHES)
def test_removed_switch_is_not_read(name):
    pat = re.compile(re.escape(name) + r"(?![A-Z0-9_])")
    bad = [p for p, src in _sources() if pat.search(src)]
    assert not bad, (name, bad)
