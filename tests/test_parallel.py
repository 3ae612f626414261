"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The key invariant (SURVEY §7 hard part #5): a render is bit-identical
across mesh shapes, because every random draw is a pure function of
(seed, global pixel id, global sample index) — never of the schedule.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mrt.core.camera import Camera
from mrt.geometry.scene import Scene
from mrt.geometry.spheres import Spheres
from mrt.materials.table import MaterialBuilder
from mrt.materials.background import SkyBackground
from mrt.parallel.mesh import make_mesh
from mrt.parallel.render import render_sharded
from mrt.runtime.render import render


def _scene():
    b = MaterialBuilder()
    ground = b.lambertian((0.5, 0.5, 0.5))
    metal = b.metal(0.1, (0.8, 0.7, 0.6))
    glass = b.dielectric(1.5)
    return Scene(
        materials=b.build(),
        background=SkyBackground.create(),
        spheres=Spheres(
            center=jnp.asarray([[0, -100.5, -1], [-0.6, 0, -1.5],
                                [0.6, 0, -1.5]], jnp.float32),
            radius=jnp.asarray([100.0, 0.5, 0.5]),
            material=jnp.asarray([ground, metal, glass], jnp.int32),
        ))


def _camera():
    return Camera.create(60.0, (0, 0.3, 1), (0, 0, -1.5), (0, 1, 0),
                         aspect_ratio=1.0)


@pytest.fixture(scope="module")
def reference_render():
    scene, camera = _scene(), _camera()
    film = render(scene, camera, 16, 16, spp=8, max_depth=6, seed=7)
    return np.asarray(film.sum), np.asarray(film.depth_sum)


@pytest.mark.parametrize("tile,spp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_mesh_shapes_match_single_device(reference_render, tile, spp):
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    scene, camera = _scene(), _camera()
    mesh = make_mesh(tile=tile, spp=spp)
    film = render_sharded(scene, camera, 16, 16, mesh, spp=8, max_depth=6,
                          seed=7)
    ref_sum, ref_depth = reference_render
    np.testing.assert_allclose(np.asarray(film.sum), ref_sum,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(film.depth_sum), ref_depth)
    assert int(film.samples) == 8


def test_film_is_row_sharded():
    scene, camera = _scene(), _camera()
    mesh = make_mesh(tile=8, spp=1)
    film = render_sharded(scene, camera, 16, 16, mesh, spp=2, max_depth=4)
    sharding = film.sum.sharding
    assert sharding.is_fully_replicated is False


def test_graft_entry_single_chip():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


def test_graft_dryrun_multichip():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


@pytest.mark.parametrize("tile,spp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_persistent_matches(reference_render, tile, spp):
    from mrt.parallel.render import (render_pass_sharded_persistent,
                                     shard_film)
    from mrt.runtime.film import Film

    scene, camera = _scene(), _camera()
    mesh = make_mesh(tile=tile, spp=spp)
    film = shard_film(Film.create(16, 16), mesh)
    fn = jax.jit(lambda s, c, f: render_pass_sharded_persistent(
        s, c, f, 7, 0, width=16, height=16, samples=8, max_depth=6,
        mesh=mesh, pool=512))
    film = fn(scene, camera, film)
    ref_sum, ref_depth = reference_render
    np.testing.assert_allclose(np.asarray(film.sum), ref_sum,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(film.depth_sum), ref_depth)
    assert int(film.samples) == 8


# ---------------------------------------------------------------------------
# Hard geometry paths under shard_map (VERDICT r3 #6): the sphere-only
# scene above never exercises TLAS traversal, the instanced brute scan,
# voxel DDA cursors, or the alpha re-cast cond — exactly the code with
# loop-carried state and varying-axes pitfalls.  Each variant must be
# bit-identical across mesh shapes and vs the single-device render.
# ---------------------------------------------------------------------------

def _tlas_scene():
    """Small instanced two-mesh scene -> TLAS path (DFS fallback on the
    CPU mesh; the brute variant below routes it through tlas_brute)."""
    from mrt.geometry.shapes import cube, sphere_mesh

    b = MaterialBuilder()
    red = b.lambertian((0.7, 0.2, 0.2))
    metal = b.metal(0.05, (0.8, 0.8, 0.9))
    from mrt.geometry.scene import SceneBuilder
    sb = SceneBuilder(b, SkyBackground.create())
    mc = sb.add_mesh(cube(size=1.0, material=red))
    ms = sb.add_mesh(sphere_mesh(radius=0.55, lat=6, lon=8,
                                 material=metal))
    for i in range(3):
        sb.add_instance(mc, translation=(i * 1.5 - 1.5, 0.0, -2.0),
                        rotation=(0.0, 0.08 * i, 0.0))
        sb.add_instance(ms, translation=(i * 1.5 - 1.5, 1.2, -2.0),
                        scale=1.0 + 0.2 * i)
    return sb.build()


def _alpha_scene():
    """Textured cutout quads -> needs_alpha re-cast rounds (lax.cond
    inside the bounce loop) + normal-free atlas sampling."""
    from mrt.geometry.shapes import quad
    from mrt.textures.atlas import AtlasBuilder, CLAMP

    atlas = AtlasBuilder()
    px = np.zeros((4, 4, 4), np.float32)
    px[..., 0] = 0.8
    px[..., 1] = 0.4
    px[:, 2:, 3] = 1.0  # right half opaque, left half cutout
    tex = atlas.add_raw(np.moveaxis(px, -1, 0), wrap=CLAMP)
    b = MaterialBuilder()
    front = b.lambertian(tex=tex)
    back = b.lambertian((0.1, 0.2, 0.8))
    from mrt.geometry.scene import SceneBuilder
    sb = SceneBuilder(b, SkyBackground.create(), atlas=atlas.build())
    sb.add_triangles(quad((-2.0, -2.0, -3.0), (4.0, 0.0, 0.0),
                          (0.0, 4.0, 0.0), material=front))
    sb.add_triangles(quad((-2.0, -2.0, -5.0), (4.0, 0.0, 0.0),
                          (0.0, 4.0, 0.0), material=back))
    scene = sb.build()
    assert scene.needs_alpha
    return scene


def _voxel_scene():
    from mrt.scenes import get
    scene, camera = get("menger")(aspect_ratio=1.0, level=2).generate()
    assert scene.voxels
    return scene, camera


def _hard_case(name):
    if name == "voxel":
        return _voxel_scene()
    cam = Camera.create(60.0, (0, 0.6, 2.5), (0, 0.3, -2), (0, 1, 0),
                        aspect_ratio=1.0)
    if name == "alpha":
        return _alpha_scene(), Camera.create(
            60.0, (0, 0, 1.5), (0, 0, -3), (0, 1, 0), aspect_ratio=1.0)
    return _tlas_scene(), cam


@pytest.mark.parametrize("name", ["tlas", "tlas_brute", "voxel",
                                  "alpha"])
@pytest.mark.parametrize("tile,spp", [(8, 1), (2, 4)])
def test_hard_paths_sharded_match(name, tile, spp, monkeypatch):
    if name == "tlas_brute":
        # Route the TLAS through the brute oracle so its while_loop's
        # carries run under shard_map on the CPU mesh.
        monkeypatch.setenv("MRT_TLAS_KERNEL", "brute")
        scene, camera = _hard_case("tlas")
    else:
        scene, camera = _hard_case(name)
    ref = render(scene, camera, 16, 16, spp=8, max_depth=5, seed=3)
    mesh = make_mesh(tile=tile, spp=spp)
    film = render_sharded(scene, camera, 16, 16, mesh, spp=8,
                          max_depth=5, seed=3)
    np.testing.assert_allclose(np.asarray(film.sum),
                               np.asarray(ref.sum), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(film.depth_sum),
                                  np.asarray(ref.depth_sum))


@pytest.mark.parametrize("name", ["tlas", "voxel"])
def test_hard_paths_sharded_persistent(name):
    """The persistent (pool regen) sharded step over the hard paths."""
    from mrt.parallel.render import (render_pass_sharded_persistent,
                                     shard_film)
    from mrt.runtime.film import Film

    scene, camera = _hard_case(name)
    ref = render(scene, camera, 16, 16, spp=4, max_depth=5, seed=3)
    mesh = make_mesh(tile=2, spp=4)
    film = shard_film(Film.create(16, 16), mesh)
    fn = jax.jit(lambda s, c, f: render_pass_sharded_persistent(
        s, c, f, 3, 0, width=16, height=16, samples=4, max_depth=5,
        mesh=mesh, pool=512))
    film = fn(scene, camera, film)
    np.testing.assert_allclose(np.asarray(film.sum),
                               np.asarray(ref.sum), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(np.asarray(film.depth_sum),
                                  np.asarray(ref.depth_sum))
