"""The XLA intersection dispatch vs brute-force oracles.

Each acceleration path is checked against a path that tests every
primitive: the sphere chunk scan and sphere BVH traversal against a
float64 NumPy quadratic, the triangle BVH traversal against the dense
scan, and the two-level TLAS traversal against the instanced brute scan
(geometry/tlas_brute.py).  Per-lane t_min vectors (the alpha re-cast
rounds) go through every traversal.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mrt.geometry import bvh as B
from mrt.geometry import spheres as S
from mrt.geometry import triangles as T
from mrt.geometry.shapes import cube, sphere_mesh


def _spheres(rng, n):
    return S.Spheres(
        center=jnp.asarray(rng.uniform(-5, 5, (n, 3)).astype(np.float32)),
        radius=jnp.asarray(rng.uniform(0.1, 1.2, n).astype(np.float32)),
        material=jnp.zeros((n,), jnp.int32))


def _rays(rng, n, lo=-8, hi=8):
    o = jnp.asarray(rng.uniform(lo, hi, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    return o, d


def numpy_sphere_t(spheres, o, d, t_min, t_max):
    """float64 nearest root per ray over every sphere (geom.rs:64-75:
    near root, else far root, within [t_min, t_max])."""
    c = np.asarray(spheres.center, np.float64)
    r = np.asarray(spheres.radius, np.float64)
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    n = o.shape[0]
    t_min = np.broadcast_to(np.asarray(t_min, np.float64), (n,))[:, None]
    t_max = np.broadcast_to(np.asarray(t_max, np.float64), (n,))[:, None]
    oc = o[:, None, :] - c[None]
    a = np.sum(d * d, -1)[:, None]
    hb = np.sum(oc * d[:, None, :], -1)
    cc = np.sum(oc * oc, -1) - r[None] ** 2
    disc = hb * hb - a * cc
    sq = np.sqrt(np.maximum(disc, 0.0))
    r0, r1 = (-hb - sq) / a, (-hb + sq) / a
    ok0 = (disc >= 0) & (r0 >= t_min) & (r0 <= t_max)
    ok1 = (disc >= 0) & (r1 >= t_min) & (r1 <= t_max)
    root = np.where(ok0, r0, np.where(ok1, r1, np.inf))
    return root.min(axis=1)


def _assert_t_close(t_got, t_ref):
    t_got, t_ref = np.asarray(t_got), np.asarray(t_ref)
    hit = np.isfinite(t_ref)
    # Grazing hits may flip between f32 and f64 arithmetic.
    assert (hit == np.isfinite(t_got)).mean() > 0.995
    both = hit & np.isfinite(t_got)
    np.testing.assert_allclose(t_got[both], t_ref[both], rtol=2e-3,
                               atol=1e-4)


def _assert_hits_match(hx, hb, exact_material=False):
    np.testing.assert_array_equal(np.asarray(hx.hit), np.asarray(hb.hit))
    m = np.asarray(hx.hit)
    np.testing.assert_allclose(np.asarray(hx.t)[m], np.asarray(hb.t)[m],
                               rtol=2e-3, atol=1e-4)
    if m.any():
        same = np.asarray(hx.material)[m] == np.asarray(hb.material)[m]
        assert same.all() if exact_material else same.mean() > 0.99


class TestSphereScan:
    @pytest.mark.parametrize("n_spheres,n_rays", [(1, 64), (13, 1000),
                                                  (484, 2048)])
    def test_matches_scan_kernel(self, rng, n_spheres, n_rays):
        spheres = _spheres(rng, n_spheres)
        o, d = _rays(rng, n_rays)
        t, _ = S.nearest_t(spheres, o, d, 1e-3, jnp.inf)
        _assert_t_close(t, numpy_sphere_t(spheres, o, d, 1e-3, np.inf))

    @pytest.mark.parametrize("n_spheres,n_rays", [(1, 64), (13, 1000),
                                                  (484, 2048)])
    def test_x_matches_scan_kernel(self, rng, n_spheres, n_rays,
                                   monkeypatch):
        # A small scan chunk exercises the chunk padding and the
        # cross-chunk running minimum.
        monkeypatch.setattr(S, "CHUNK", 8)
        spheres = _spheres(rng, n_spheres)
        o, d = _rays(rng, n_rays)
        t, i = S.nearest_t(spheres, o, d, 1e-3, jnp.inf)
        _assert_t_close(t, numpy_sphere_t(spheres, o, d, 1e-3, np.inf))
        assert (np.asarray(i) < n_spheres).all()

    def test_x_t_range_and_per_ray_bounds(self, rng):
        spheres = _spheres(rng, 16)
        o, d = _rays(rng, 256)
        t, _ = S.nearest_t(spheres, o, d, 0.5, 4.0)
        _assert_t_close(t, numpy_sphere_t(spheres, o, d, 0.5, 4.0))
        tmax = jnp.asarray(rng.uniform(2.0, 6.0, 256).astype(np.float32))
        t2, _ = S.nearest_t(spheres, o, d, 1e-3, tmax)
        _assert_t_close(t2, numpy_sphere_t(spheres, o, d, 1e-3, tmax))

    def test_t_range_respected(self, rng):
        spheres = _spheres(rng, 16)
        o, d = _rays(rng, 256)
        hits = S.intersect(spheres, o, d, 0.5, 4.0)
        t = np.asarray(hits.t)[np.asarray(hits.hit)]
        assert ((t >= 0.5) & (t <= 4.0)).all()
        _assert_t_close(hits.t, numpy_sphere_t(spheres, o, d, 0.5, 4.0))


def _grid_spheres(rng, n):
    import math
    side = int(math.sqrt(n))
    centers = np.array([[i * 2.0, 0.0, j * 2.0]
                        for i in range(side) for j in range(side)],
                       np.float32)
    centers += rng.uniform(-0.3, 0.3, centers.shape).astype(np.float32)
    return S.Spheres(
        center=jnp.asarray(centers),
        radius=jnp.asarray(rng.uniform(0.3, 0.9, len(centers))
                           .astype(np.float32)),
        material=jnp.asarray(np.arange(len(centers), dtype=np.int32)))


class TestSphereBVH:
    @pytest.mark.parametrize("n", [16, 400])
    def test_matches_xla_traversal(self, rng, n):
        spheres = _grid_spheres(rng, n)
        bvh, reordered = B.build_over_spheres(spheres)
        o, d = _rays(rng, 1500, -5, 45)
        hx = B.intersect_bvh_spheres(reordered, bvh, o, d, 1e-3, jnp.inf)
        # The f64 quadratic, not the f32 scan: the scan's expanded form
        # loses digits for spheres far from the origin.
        _assert_t_close(hx.t, numpy_sphere_t(reordered, o, d, 1e-3,
                                             np.inf))

    def test_t_max(self, rng):
        spheres = _grid_spheres(rng, 64)
        bvh, reordered = B.build_over_spheres(spheres)
        o = jnp.asarray(np.tile([[-4.0, 0.0, 4.0]], (8, 1)))
        d = jnp.asarray(np.tile([[1.0, 0.0, 0.0]], (8, 1)))
        hx = B.intersect_bvh_spheres(reordered, bvh, o, d, 1e-3, 3.0)
        hb = S.intersect(reordered, o, d, 1e-3, 3.0)
        np.testing.assert_array_equal(np.asarray(hx.hit),
                                      np.asarray(hb.hit))


class TestTriBVH:
    def test_matches_xla_traversal(self, rng):
        tris = sphere_mesh((0, 0, 0), 2.0, lat=12, lon=18)
        bvh, reordered = B.build_over_triangles(tris)
        o, d = _rays(rng, 1200, -6, 6)
        hx = B.intersect_bvh(reordered, bvh, o, d, 1e-3, jnp.inf)
        hb = T.intersect_brute(reordered, o, d, 1e-3, jnp.inf)
        _assert_hits_match(hx, hb)
        m = np.asarray(hx.hit)
        np.testing.assert_allclose(np.asarray(hx.uv)[m],
                                   np.asarray(hb.uv)[m], rtol=1e-2,
                                   atol=2e-3)


def _fleet(n_side=4, rotate=True):
    from mrt.geometry.instance import MeshRegistry

    reg = MeshRegistry()
    m1 = reg.add_mesh(cube(size=1.0, material=1))
    m2 = reg.add_mesh(sphere_mesh(radius=0.6, lat=6, lon=8, material=2))
    for i in range(n_side):
        for j in range(n_side):
            mid = m1 if (i + j) % 2 == 0 else m2
            reg.add_instance(mid, translation=(i * 2.0, 0.0, j * 2.0),
                             rotation=(0.0, 0.1 * i if rotate else 0.0,
                                       0.0),
                             scale=1.0 + 0.2 * j)
    return reg.build()


class TestTLAS:
    def test_matches_xla_tlas(self, rng):
        from mrt.geometry.instance import intersect_tlas
        from mrt.geometry.tlas_brute import intersect_tlas_brute

        tlas = _fleet()
        o, d = _rays(rng, 1500, -4, 10)
        hx = intersect_tlas(tlas, o, d, 1e-3, jnp.inf)
        hb = intersect_tlas_brute(tlas, o, d, 1e-3, jnp.inf)
        _assert_hits_match(hx, hb, exact_material=True)
        m = np.asarray(hx.hit)
        np.testing.assert_allclose(np.asarray(hx.normal)[m],
                                   np.asarray(hb.normal)[m], rtol=1e-5,
                                   atol=1e-5)


class TestVectorTmin:
    """Per-lane t_min vectors (the alpha re-cast rounds) through each
    traversal, vs the brute paths (which broadcast natively)."""

    def test_tri_kernel_vector_tmin(self, rng):
        tris = sphere_mesh((0, 0, 0), 2.0, lat=10, lon=14)
        bvh, reordered = B.build_over_triangles(tris)
        o, d = _rays(rng, 512, -5, 5)
        t_min = jnp.asarray(rng.uniform(1e-3, 3.0, 512).astype(np.float32))
        hx = B.intersect_bvh(reordered, bvh, o, d, t_min, jnp.inf)
        hb = T.intersect_brute(reordered, o, d, t_min, jnp.inf)
        _assert_hits_match(hx, hb)

    def test_tlas_kernels_vector_tmin(self, rng):
        from mrt.geometry.instance import intersect_tlas
        from mrt.geometry.tlas_brute import intersect_tlas_brute

        tlas = _fleet(n_side=3)
        o, d = _rays(rng, 512, -2, 7)
        t_min = jnp.asarray(rng.uniform(1e-3, 2.0, 512).astype(np.float32))
        hx = intersect_tlas(tlas, o, d, t_min, jnp.inf)
        hb = intersect_tlas_brute(tlas, o, d, t_min, jnp.inf)
        _assert_hits_match(hx, hb, exact_material=True)

    def test_stream_kernel_vector_tmin(self, rng):
        # Sphere BVH traversal with per-lane t_min, vs the dense scan.
        spheres = _grid_spheres(rng, 100)
        bvh, reordered = B.build_over_spheres(spheres)
        o, d = _rays(rng, 512, -5, 25)
        t_min = jnp.asarray(rng.uniform(1e-3, 6.0, 512).astype(np.float32))
        hx = B.intersect_bvh_spheres(reordered, bvh, o, d, t_min, jnp.inf)
        _assert_t_close(hx.t, numpy_sphere_t(reordered, o, d, t_min,
                                             np.inf))
