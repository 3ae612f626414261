"""Homogeneous participating media: sphere-bounded (analytic) and
arbitrary-mesh-bounded.

The reference's `Volume<I>` wraps any `Intersect` and samples an
exponential free-flight distance between the boundary's entry and exit
hits (reference: src/geom.rs:595-660).  Every reference *scene* wraps a
`Sphere` (scenes/eve.rs:33-45) — `VolumeSpheres` is the fast analytic
SoA form for that case — while `MeshVolume` reproduces the general
capability: the boundary is any instanced mesh, entry/exit found by two
TLAS traversals exactly like the reference's two nested
`target.intersect` calls (geom.rs:612-619).  Scatter events use the
Isotropic material class.

Semantics matched to geom.rs:611-655:
  entry = near sphere root with t_min = -inf; exit = next root after
  entry+1e-4; entry clamped to caller t_min then 0; exit clamped to
  t_max; reject when entry >= exit; free flight = ln(u) * (-1/density),
  rejected when it overshoots the inside distance.  The event's normal
  is the reference's arbitrary (1,0,0) with front_face = true.

The reference evaluates volumes against its shrinking closest-so-far;
evaluating against the full t_max and min-folding afterwards is
distribution-identical by the memorylessness of the exponential.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from .hit import Hits, INF


@struct.dataclass
class VolumeSpheres:
    center: jnp.ndarray           # (V,3)
    radius: jnp.ndarray           # (V,)
    neg_inv_density: jnp.ndarray  # (V,)  -1/density (geom.rs:603)
    material: jnp.ndarray         # (V,)  isotropic material row

    @property
    def count(self):
        return self.center.shape[0]


def intersect(vols: VolumeSpheres, o, d, t_min, t_max, u) -> Hits:
    """Sample scatter events in all volumes; returns nearest per ray.

    u: (N, V) uniforms in [0,1), one per (ray, volume).
    """
    n = o.shape[0]
    c = vols.center                                   # (V,3)
    oc = o[None, :, :] - c[:, None, :]                # (V,N,3)
    a = jnp.sum(d * d, axis=-1)[None, :]              # (1,N)
    half_b = jnp.sum(oc * d[None, :, :], axis=-1)     # (V,N)
    cterm = (jnp.sum(oc * oc, axis=-1)
             - (vols.radius ** 2)[:, None])           # (V,N)
    disc = half_b * half_b - a * cterm
    has_roots = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-half_b - sq) / a                           # entry (t_min=-inf)
    t1 = (-half_b + sq) / a

    # Exit = next root after entry + 1e-4 (geom.rs:612-619).
    has_exit = has_roots & (t1 >= t0 + 1e-4)

    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                               (n,))[None, :]
    enter = jnp.maximum(t0, t_min)                    # geom.rs:621-623
    exit_ = jnp.minimum(t1, t_max_b)                  # geom.rs:624-626
    ok = has_exit & (enter < exit_)                   # geom.rs:628-630
    enter = jnp.maximum(enter, 0.0)                   # geom.rs:632-634

    ray_len = jnp.sqrt(a)                             # (1,N)
    dist_inside = (exit_ - enter) * ray_len
    hit_dist = jnp.log(u.T) * vols.neg_inv_density[:, None]   # (V,N)
    ok = ok & (hit_dist <= dist_inside)

    t = jnp.where(ok, enter + hit_dist / ray_len, INF)        # (V,N)
    best = jnp.min(t, axis=0)                                 # (N,)
    which = jnp.argmin(t, axis=0)                             # (N,)
    hit = jnp.isfinite(best)
    t_safe = jnp.where(hit, best, 0.0)

    normal = jnp.zeros((n, 3), jnp.float32).at[:, 0].set(1.0)
    return Hits(
        t=jnp.where(hit, best, INF),
        point=o + d * t_safe[:, None],
        normal=normal,                       # arbitrary (geom.rs:647)
        front_face=jnp.ones((n,), bool),     # geom.rs:650
        uv=jnp.zeros((n, 2), jnp.float32),
        material=vols.material[which],
        hit=hit,
        tangent=jnp.zeros((n, 3), jnp.float32),
        bitangent=jnp.zeros((n, 3), jnp.float32),
        prim_area=jnp.zeros((n,), jnp.float32),
    )


from typing import Any


@struct.dataclass
class MeshVolume:
    """A homogeneous medium bounded by one instanced mesh
    (geom.rs:595-660 `Volume<I>` with I = transformed Model)."""
    tlas: Any                      # single-instance TLAS of the boundary
    neg_inv_density: jnp.ndarray   # ()  -1/density
    material: jnp.ndarray          # ()  isotropic material row


def intersect_mesh(vol: MeshVolume, o, d, t_min, t_max, u) -> Hits:
    """Reference Volume::intersect semantics over a mesh boundary.

    entry = closest boundary hit with (-inf, inf); exit = closest hit
    after entry + 1e-4 (geom.rs:612-619); clamps and the exponential
    free flight as in the sphere path.  u: (N,) uniforms.
    """
    from .instance import intersect_tlas

    n = o.shape[0]
    neg_inf = jnp.float32(-jnp.inf)
    h_enter = intersect_tlas(vol.tlas, o, d, neg_inf, jnp.inf)
    t0 = h_enter.t                                     # INF on miss
    h_exit = intersect_tlas(vol.tlas, o, d,
                            jnp.where(h_enter.hit, t0 + 1e-4, 0.0),
                            jnp.inf)
    t1 = h_exit.t
    has_exit = h_enter.hit & h_exit.hit

    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    enter = jnp.maximum(jnp.where(h_enter.hit, t0, 0.0), t_min)
    exit_ = jnp.minimum(jnp.where(has_exit, t1, 0.0), t_max_b)
    ok = has_exit & (enter < exit_)
    enter = jnp.maximum(enter, 0.0)

    ray_len = jnp.sqrt(jnp.sum(d * d, axis=-1))
    dist_inside = (exit_ - enter) * ray_len
    hit_dist = jnp.log(jnp.maximum(u, 1e-38)) * vol.neg_inv_density
    ok = ok & (hit_dist <= dist_inside)

    t = jnp.where(ok, enter + hit_dist / ray_len, INF)
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    normal = jnp.zeros((n, 3), jnp.float32).at[:, 0].set(1.0)
    return Hits(
        t=t,
        point=o + d * t_safe[:, None],
        normal=normal,                       # arbitrary (geom.rs:647)
        front_face=jnp.ones((n,), bool),     # geom.rs:650
        uv=jnp.zeros((n, 2), jnp.float32),
        material=jnp.broadcast_to(vol.material, (n,)),
        hit=hit,
        tangent=jnp.zeros((n, 3), jnp.float32),
        bitangent=jnp.zeros((n, 3), jnp.float32),
        prim_area=jnp.zeros((n,), jnp.float32),
    )
