"""Instanced brute TLAS path vs the per-lane XLA traversal.

The brute path (geometry/tlas_brute.py) is the traversal's oracle;
its winner must match the two-level traversal exactly — both share the
deterministic (t, instance, triangle) tie rule and the same
object-space warp + Möller–Trumbore expressions.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mrt.geometry.instance import MeshRegistry, intersect_tlas
from mrt.geometry.tlas_brute import intersect_tlas_brute, wants_brute
from mrt.geometry.shapes import cube, sphere_mesh


def _fleet_tlas(rng, ni=5):
    reg = MeshRegistry()
    m1 = reg.add_mesh(cube(size=1.0, material=1))
    m2 = reg.add_mesh(sphere_mesh(radius=0.6, lat=6, lon=8, material=2))
    for i in range(ni):
        for j in range(ni):
            mid = m1 if (i + j) % 2 == 0 else m2
            reg.add_instance(mid, translation=(i * 1.6, 0.0, j * 1.6),
                             rotation=(0.0, 0.1 * i, 0.05 * j),
                             scale=1.0 + 0.2 * j,
                             material=7 if (i + j) % 3 == 0 else None)
    return reg.build()


def _assert_hits_equal(ha, hb):
    np.testing.assert_array_equal(np.asarray(ha.hit), np.asarray(hb.hit))
    m = np.asarray(ha.hit)
    for field in ("t", "uv", "normal", "material", "point", "tangent",
                  "bitangent", "prim_area", "front_face"):
        a = np.asarray(getattr(ha, field))[m]
        b = np.asarray(getattr(hb, field))[m]
        np.testing.assert_array_equal(a, b, err_msg=field)


class TestTlasBrute:
    def test_matches_xla_tlas_bitexact(self, rng):
        tlas = _fleet_tlas(rng)
        nr = 2000
        o = jnp.asarray(rng.uniform(-3, 9, (nr, 3)).astype(np.float32))
        d = jnp.asarray(rng.standard_normal((nr, 3)).astype(np.float32))

        hx = intersect_tlas(tlas, o, d, 1e-3, jnp.inf)
        hb = intersect_tlas_brute(tlas, o, d, 1e-3, jnp.inf)
        assert np.asarray(hx.hit).mean() > 0.1  # the workload is real
        _assert_hits_equal(hx, hb)

    def test_vector_t_min(self, rng):
        # The alpha re-cast path passes per-lane t_min vectors.
        tlas = _fleet_tlas(rng, ni=3)
        nr = 512
        o = jnp.asarray(rng.uniform(-2, 6, (nr, 3)).astype(np.float32))
        d = jnp.asarray(rng.standard_normal((nr, 3)).astype(np.float32))
        t_min = jnp.asarray(
            rng.uniform(1e-3, 2.0, nr).astype(np.float32))

        hx = intersect_tlas(tlas, o, d, t_min, jnp.inf)
        hb = intersect_tlas_brute(tlas, o, d, t_min, jnp.inf)
        _assert_hits_equal(hx, hb)

    def test_finite_t_max(self, rng):
        tlas = _fleet_tlas(rng, ni=3)
        nr = 512
        o = jnp.asarray(rng.uniform(-2, 6, (nr, 3)).astype(np.float32))
        d = jnp.asarray(rng.standard_normal((nr, 3)).astype(np.float32))

        hx = intersect_tlas(tlas, o, d, 1e-3, 3.0)
        hb = intersect_tlas_brute(tlas, o, d, 1e-3, 3.0)
        _assert_hits_equal(hx, hb)

    def test_single_instance(self, rng):
        reg = MeshRegistry()
        m = reg.add_mesh(sphere_mesh(radius=1.0, lat=8, lon=10,
                                     material=3))
        reg.add_instance(m, translation=(0, 0, 0), scale=(2.0, 1.0, 0.5))
        tlas = reg.build()
        nr = 256
        o = jnp.asarray(rng.uniform(-4, 4, (nr, 3)).astype(np.float32))
        d = jnp.asarray(rng.standard_normal((nr, 3)).astype(np.float32))
        _assert_hits_equal(intersect_tlas(tlas, o, d, 1e-3, jnp.inf),
                           intersect_tlas_brute(tlas, o, d, 1e-3,
                                                jnp.inf))

    def test_degenerate_directions(self, rng):
        # Axis-aligned and zero-direction (idle-lane neutral) rays.
        tlas = _fleet_tlas(rng, ni=2)
        o = jnp.asarray(np.tile([[1.0, 5.0, 1.0]], (8, 1)),
                        jnp.float32)
        d = jnp.asarray([[0, -1, 0], [0, 1, 0], [1, 0, 0], [0, 0, 1],
                         [0, 0, 0], [0, -1, 0], [-1, 0, 0],
                         [0, 0, -1]], jnp.float32)
        hx = intersect_tlas(tlas, o, d, 1e-3, jnp.inf)
        hb = intersect_tlas_brute(tlas, o, d, 1e-3, jnp.inf)
        _assert_hits_equal(hx, hb)

    def test_wants_brute_gate(self, rng, monkeypatch):
        tlas = _fleet_tlas(rng, ni=2)
        # The oracle is opt-in: MRT_TLAS_KERNEL=brute and nothing else.
        monkeypatch.delenv("MRT_TLAS_KERNEL", raising=False)
        assert not wants_brute(tlas)
        for other in ("auto", "flat", "packet"):
            monkeypatch.setenv("MRT_TLAS_KERNEL", other)
            assert not wants_brute(tlas)
        monkeypatch.setenv("MRT_TLAS_KERNEL", "brute")
        assert wants_brute(tlas)

    def test_eve_scene_parity(self, rng):
        from mrt.scenes import get

        scene, camera = get("eve")().generate()
        nr = 1024
        px = jnp.asarray(rng.uniform(0, 1, nr).astype(np.float32))
        py = jnp.asarray(rng.uniform(0, 1, nr).astype(np.float32))
        o, d = camera.rays(px, py, jnp.zeros(nr), jnp.zeros(nr))
        hx = intersect_tlas(scene.tlas, o, d, 1e-3, jnp.inf)
        hb = intersect_tlas_brute(scene.tlas, o, d, 1e-3, jnp.inf)
        assert np.asarray(hx.hit).mean() > 0.05
        _assert_hits_equal(hx, hb)
