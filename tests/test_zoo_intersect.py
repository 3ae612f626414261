"""Scene.intersect on every zoo scene vs a float64 NumPy brute force.

The NumPy oracle tests every primitive of the scene with no
acceleration structure: every sphere, every loose triangle, every
instance's mesh triangles in the instance's object space (t is
affine-invariant), and every solid voxel cell as a box.  Volumes are
stochastic and alpha cut-outs depend on textures, so both are left out:
the comparison is of closest-hit geometry only.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mrt import scenes
from mrt.geometry.scene import T_MIN

N_RAYS = 384


def _spheres_t(c, r, o, d, t_min):
    oc = o[:, None, :] - c[None]
    a = np.sum(d * d, -1)[:, None]
    hb = np.sum(oc * d[:, None, :], -1)
    cc = np.sum(oc * oc, -1) - r[None] ** 2
    disc = hb * hb - a * cc
    sq = np.sqrt(np.maximum(disc, 0.0))
    r0, r1 = (-hb - sq) / a, (-hb + sq) / a
    root = np.where((disc >= 0) & (r0 >= t_min), r0,
                    np.where((disc >= 0) & (r1 >= t_min), r1, np.inf))
    return root.min(axis=1)


def _tris_t(va, ab, ac, o, d, t_min, chunk=2048):
    """Möller–Trumbore over every triangle (geom.rs:503-544)."""
    best = np.full(o.shape[0], np.inf)
    for k in range(0, va.shape[0], chunk):
        a, e1, e2 = va[k:k + chunk], ab[k:k + chunk], ac[k:k + chunk]
        p = np.cross(d[:, None, :], e2[None])
        det = np.sum(e1[None] * p, -1)
        ok = np.abs(det) >= 1e-6
        inv = 1.0 / np.where(ok, det, 1.0)
        tv = o[:, None, :] - a[None]
        u = np.sum(tv * p, -1) * inv
        q = np.cross(tv, e1[None])
        v = np.sum(d[:, None, :] * q, -1) * inv
        t = np.sum(e2[None] * q, -1) * inv
        ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= t_min)
        best = np.minimum(best, np.where(ok, t, np.inf).min(axis=1))
    return best


def _boxes_t(lo, hi, o, d, t_min):
    inv = 1.0 / d
    t0 = (lo[None] - o[:, None, :]) * inv[:, None, :]
    t1 = (hi[None] - o[:, None, :]) * inv[:, None, :]
    near = np.minimum(t0, t1).max(-1)
    far = np.maximum(t0, t1).min(-1)
    # A ray starting inside a solid cell hits its exit face.
    t = np.where(near >= t_min, near, far)
    return np.where((near <= far) & (t >= t_min), t, np.inf).min(axis=1)


def numpy_closest_t(scene, o, d, t_min=T_MIN):
    f64 = lambda x: np.asarray(x, np.float64)
    best = np.full(o.shape[0], np.inf)
    if scene.spheres is not None:
        best = np.minimum(best, _spheres_t(
            f64(scene.spheres.center), f64(scene.spheres.radius), o, d,
            t_min))
    if scene.triangles is not None:
        tr = scene.triangles
        best = np.minimum(best, _tris_t(f64(tr.va), f64(tr.e_ab),
                                        f64(tr.e_ac), o, d, t_min))
    if scene.tlas is not None:
        tl = scene.tlas
        inv = f64(tl.inv_transform)
        va, ab, ac = f64(tl.tris.va), f64(tl.tris.e_ab), f64(tl.tris.e_ac)
        first, count = np.asarray(tl.tri_first), np.asarray(tl.tri_count)
        for i in range(inv.shape[0]):
            lin, off = inv[i, :3, :3], inv[i, :3, 3]
            s = slice(first[i], first[i] + count[i])
            best = np.minimum(best, _tris_t(
                va[s], ab[s], ac[s], o @ lin.T + off, d @ lin.T, t_min))
    for g in scene.voxels or ():
        from mrt.scenes.menger import sponge_occupancy

        assert g.rule == "menger"
        idx = np.argwhere(sponge_occupancy(g.levels)).astype(np.float64)
        lo = f64(g.origin) + idx * float(g.cell)
        best = np.minimum(best, _boxes_t(lo, lo + float(g.cell), o, d,
                                         t_min))
    return best


ZOO = {
    "rtiow": dict(),
    "cornell": dict(),
    "sphere_grid": dict(),
    "lucy": dict(),
    "menger": dict(level=2),
    "eve": dict(),
    "playground": dict(),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_scene_intersect_matches_numpy(name):
    rng = np.random.default_rng(11)
    scene, camera = scenes.get(name)(aspect_ratio=16 / 9,
                                     **ZOO[name]).generate()
    scene = scene.replace(volumes=None, mesh_volumes=None)
    s = jnp.asarray(rng.uniform(0, 1, N_RAYS).astype(np.float32))
    t = jnp.asarray(rng.uniform(0, 1, N_RAYS).astype(np.float32))
    o, d = camera.rays(s, t, jnp.zeros(N_RAYS), jnp.zeros(N_RAYS))
    # Half the rays scattered off the camera frustum: incoherent
    # directions reach geometry a pinhole view never sees.
    half = N_RAYS // 2
    d = d.at[half:].add(jnp.asarray(
        0.5 * rng.standard_normal((N_RAYS - half, 3)).astype(np.float32))
        * jnp.linalg.norm(d[half:], axis=-1, keepdims=True))

    hit_t = jax.jit(lambda sc, o, d: sc._intersect_once(
        o, d, T_MIN, jnp.inf, None, shading_aux=False).t)(scene, o, d)
    got = np.asarray(hit_t)
    ref = numpy_closest_t(scene, np.asarray(o, np.float64),
                          np.asarray(d, np.float64))

    hit = np.isfinite(ref)
    assert hit.sum() >= 16, f"{name}: too few hits to compare"
    # Grazing rays may flip between f32 and f64 arithmetic.
    agree = hit == np.isfinite(got)
    assert agree.mean() >= 0.99, (name, agree.mean())
    both = hit & np.isfinite(got)
    close = np.isclose(got[both], ref[both], rtol=1e-3, atol=1e-3)
    assert close.mean() >= 0.99, (name, close.mean())
