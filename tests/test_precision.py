"""Every f32 geometry product on the traced path asks for full precision.

A GPU may run a float32 matrix product in TF32 (~3 decimal digits)
unless the product asks for HIGHEST; an instance warp or normal
transform at that precision moves hits.  Each check traces the code
and inspects every dot_general in the jaxpr, sub-jaxprs included.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import lax

from mrt.geometry.shapes import cube, sphere_mesh
from mrt.math import m4


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dots(sub)


def _assert_highest(fn, *args, min_dots=1):
    dots = list(_dots(jax.make_jaxpr(fn)(*args).jaxpr))
    assert len(dots) >= min_dots
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None, eqn
        if not isinstance(prec, tuple):
            prec = (prec, prec)
        assert all(p == lax.Precision.HIGHEST for p in prec), eqn


def _tlas():
    from mrt.geometry.instance import MeshRegistry

    reg = MeshRegistry()
    a = reg.add_mesh(cube(size=1.0, material=1))
    b = reg.add_mesh(sphere_mesh(radius=0.6, lat=4, lon=6, material=2))
    reg.add_instance(a, translation=(0.0, 0.0, -3.0), rotation=(0, 0.1, 0))
    reg.add_instance(b, translation=(1.5, 0.0, -3.0), scale=(1, 2, 1))
    return reg.build()


def _rays(n=8):
    o = jnp.zeros((n, 3), jnp.float32)
    d = jnp.asarray(np.tile([[0.1, 0.0, -1.0]], (n, 1)), jnp.float32)
    return o, d


def test_instance_ray_warp():
    from mrt.geometry.instance import intersect_tlas

    o, d = _rays()
    _assert_highest(lambda o, d: intersect_tlas(_tlas(), o, d, 1e-3,
                                                jnp.inf).t, o, d,
                    min_dots=7)   # warp o, d + 5 winner transforms


def test_instance_winner_transforms():
    from mrt.geometry.instance import expand_winner

    o, d = _rays()
    z = jnp.zeros(8, jnp.float32)
    i = jnp.zeros(8, jnp.int32)
    _assert_highest(lambda o, d: expand_winner(
        _tlas(), o, d, z + 3.0, i, i, z, z).normal, o, d, min_dots=5)


def test_tlas_brute_warp():
    from mrt.geometry.tlas_brute import intersect_tlas_brute

    o, d = _rays()
    _assert_highest(lambda o, d: intersect_tlas_brute(
        _tlas(), o, d, 1e-3, jnp.inf).t, o, d, min_dots=2)


@pytest.mark.parametrize("fn", [m4.transform_point, m4.transform_vector])
def test_m4_transforms(fn):
    m = m4.trs((1.0, 2.0, 3.0), (0.1, 0.2, 0.3), (1.0, 2.0, 1.0))
    _assert_highest(fn, m, jnp.ones((5, 3), jnp.float32))


def test_m4_compositions():
    _assert_highest(lambda t: m4.trs(t, (0.1, 0.2, 0.3), (1, 2, 1)),
                    jnp.ones(3), min_dots=4)
    _assert_highest(lambda t: m4.trs_inverse(t, (0.1, 0.2, 0.3),
                                             (1, 2, 1)),
                    jnp.ones(3), min_dots=4)


def test_whole_render_step_has_no_default_precision_dot():
    """Any dot_general anywhere in a TLAS-scene persistent pass is
    pinned (spheres, meshes, instances, textures, backgrounds)."""
    from mrt.scenes import get
    from mrt.integrator.persistent import render_samples_persistent

    scene, camera = get("cornell")(aspect_ratio=1.0).generate()
    _assert_highest(lambda s, c: render_samples_persistent(
        s, c, 8, 8, 1, 0, 1, max_depth=2, pool=64)[0], scene, camera)
