"""Scene zoo: every registered scene builds and renders a sane image."""

import numpy as np
import pytest

from mrt import scenes
from mrt.runtime.render import render


def _make(name):
    kwargs = {"aspect_ratio": 1.0}
    if name == "menger":
        kwargs["level"] = 2      # 400 cubes, not 3.2M
    if name == "sphere_grid":
        kwargs["dim"] = 6        # 144 spheres
    if name == "rtiow":
        kwargs["grid"] = 3
    return scenes.get(name)(**kwargs)


@pytest.mark.parametrize("name", scenes.names())
def test_scene_renders(name):
    scene, camera = _make(name).generate()
    film = render(scene, camera, 24, 24, spp=4, max_depth=6, seed=2)
    img = np.asarray(film.mean())
    assert np.isfinite(img).all(), f"{name}: non-finite radiance"
    assert img.min() >= 0.0
    assert img.max() > 1e-4, f"{name}: black image"


def test_cornell_light_on_ceiling():
    scene, camera = _make("cornell").generate()
    film = render(scene, camera, 32, 32, spp=8, max_depth=8, seed=2)
    img = np.asarray(film.mean())
    # Rows are bottom-up: ceiling (light) in the top rows of the array.
    top = img[-8:].mean()
    bottom = img[:8].mean()
    assert top > bottom, "ceiling light should dominate"
    # Left wall red tint, right wall green tint.
    left = img[8:24, :8]
    right = img[8:24, -8:]
    assert left[..., 0].mean() > left[..., 1].mean()
    assert right[..., 1].mean() > right[..., 0].mean()


def test_sphere_grid_center_glows():
    scene, camera = _make("sphere_grid").generate()
    film = render(scene, camera, 32, 32, spp=4, max_depth=4, seed=2)
    img = np.asarray(film.mean())
    assert img.max() > 0.5  # emissive center sphere visible


def test_menger_positions_count():
    from mrt.scenes.menger import sponge_positions
    assert sponge_positions(1).shape == (20, 3)
    assert sponge_positions(2).shape == (400, 3)
    # Level-2 positions are distinct.
    p = sponge_positions(2)
    assert len({tuple(x) for x in p.tolist()}) == 400
