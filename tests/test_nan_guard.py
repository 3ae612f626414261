"""The eve NaN-pixel root cause (r5) and its guards.

Diagnosis: inside the fog volume an
isotropic scatter drew u3 == 0.0 exactly, the closed-form
in_unit_sphere returned the ZERO VECTOR, and the degenerate
zero-direction ray's cubemap background eval divided 0/0 -> one NaN
pixel that poisons every later pass.  The CPU and the accelerator
reproduce it identically (not a hardware quirk); the reference's rejection
sampler would need three simultaneous exact-zero draws, so the zero
vector was this port's closed-form artifact.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp

from mrt.math import sampling


def test_in_unit_sphere_never_zero():
    # The exact-zero radius draw maps to a small nonzero point now.
    u0 = jnp.zeros((4,))
    v = np.asarray(sampling.in_unit_sphere(u0, u0, u0))
    assert (np.linalg.norm(v, axis=-1) > 0).all()
    # Nonzero draws are bit-identical to the unclamped form.
    rng = np.random.default_rng(0)
    u = [jnp.asarray(rng.uniform(2.0 ** -24, 1.0, 64).astype(np.float32))
         for _ in range(3)]
    v1 = np.asarray(sampling.in_unit_sphere(*u))
    ref = np.asarray(sampling.unit_vector(u[0], u[1])
                     * jnp.cbrt(u[2])[..., None])
    np.testing.assert_array_equal(v1, ref)


def test_cubemap_zero_direction_is_the_nan_source():
    # Documents the downstream mechanism the clamp prevents: a
    # zero-direction cubemap lookup is 0/0.
    from mrt.scenes import get

    scene, camera = get("eve")(aspect_ratio=1.0).generate()
    bg = np.asarray(scene.background_eval(jnp.zeros((8, 3))))
    assert np.isnan(bg).any()


def test_film_nan_guard_drops_nonfinite(monkeypatch):
    # MRT_NAN_GUARD=1: a scene whose emission is NaN cannot poison
    # the film.
    from mrt.core.camera import Camera
    from mrt.geometry.scene import Scene
    from mrt.geometry.spheres import Spheres
    from mrt.materials.table import MaterialBuilder
    from mrt.materials.background import SolidBackground
    from mrt.integrator.persistent import render_samples_chunked

    b = MaterialBuilder()
    bad = b.diffuse_light((np.nan, 1.0, 1.0))
    table = b.build()
    scene = Scene(
        materials=table,
        background=SolidBackground.create((0.1, 0.2, 0.3)),
        spheres=Spheres(center=jnp.asarray([[0.0, 0.0, -2.0]]),
                        radius=jnp.asarray([0.5]),
                        material=jnp.asarray([bad], jnp.int32)))
    camera = Camera.create(60.0, (0, 0, 0), (0, 0, -1), (0, 1, 0),
                           aspect_ratio=1.0)
    kw = dict(width=16, height=16, seed=1, sample_start=0, samples=2,
              max_depth=3, pool=512)
    f0, _ = render_samples_chunked(scene, camera, **kw)
    assert np.isnan(np.asarray(f0)).any()
    monkeypatch.setenv("MRT_NAN_GUARD", "1")
    jax.clear_caches()   # env read at trace time
    f1, _ = render_samples_chunked(scene, camera, **kw)
    monkeypatch.delenv("MRT_NAN_GUARD")
    jax.clear_caches()
    a1 = np.asarray(f1)
    assert np.isfinite(a1).all()
    # Background radiance is untouched.
    assert a1.max() > 0
