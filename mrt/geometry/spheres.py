"""Batched ray-sphere intersection.

The reference intersects one ray against one sphere at a time via virtual
dispatch (src/geom.rs:56-93).  Here a wavefront of N rays is intersected
against all S spheres as dense vector math:

  half_b[s, r] = dot(o_r, d_r) - dot(c_s, d_r)
  c_term[s, r] = |o_r|^2 - 2 dot(c_s, o_r) + |c_s|^2 - radius_s^2

The pair terms dot(c, d) and dot(c, o) are broadcast elementwise math —
a matmul there is a fusion boundary that materialises the (S,N) products
in device memory (see nearest_t).  To keep the (S, N) intermediates out of
device memory we
scan over sphere chunks carrying a running (best_t, best_index); XLA
fuses each chunk's math into the reduction.

Root selection matches geom.rs:64-75: try the near root, fall back to the
far root, reject if outside [t_min, t_best).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from .hit import Hits, set_face_normal, INF

# Spheres per scan chunk: bounds the (CHUNK, N) temporaries so XLA can
# keep them fused for typical wavefront batch sizes (~128k rays).
import os as _os

CHUNK = int(_os.environ.get("MRT_SPHERE_CHUNK", "128"))


@struct.dataclass
class Spheres:
    center: jnp.ndarray    # (S,3)
    radius: jnp.ndarray    # (S,)
    material: jnp.ndarray  # (S,) int32

    @property
    def count(self):
        return self.center.shape[0]


def _pad_to(x, n, fill=0.0):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths, constant_values=fill)


def nearest_t(spheres: Spheres, o, d, t_min, t_max):
    """Nearest valid sphere hit per ray.

    Args:
      o, d: (N, 3) ray origins/directions (directions unnormalised, as in
        the reference).
      t_min: scalar; t_max: scalar or (N,).
    Returns:
      (t, index): (N,) float32 with +inf for miss, (N,) int32.
    """
    n = o.shape[0]
    s = spheres.count
    chunk = min(CHUNK, max(8, s))
    s_pad = ((s + chunk - 1) // chunk) * chunk
    k = s_pad // chunk

    centers = _pad_to(spheres.center, s_pad).reshape(k, chunk, 3)
    # Padded spheres get radius 0 => c_term > 0 & disc < 0 => never hit.
    radii = _pad_to(spheres.radius, s_pad).reshape(k, chunk)
    base = jnp.arange(k, dtype=jnp.int32) * chunk

    od = jnp.sum(o * d, axis=-1)          # (N,)
    oo = jnp.sum(o * o, axis=-1)          # (N,)
    a = jnp.sum(d * d, axis=-1)           # (N,)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    def body(carry, chunk_in):
        best_t, best_i = carry
        c, r, b0 = chunk_in
        cc_rr = jnp.sum(c * c, axis=-1) - r * r            # (C,)
        # Pair dot products as broadcast elementwise math (exact f32).
        # A jnp.dot here (even precision=HIGHEST, which large-coordinate
        # spheres require) is a fusion BOUNDARY: XLA materialises the
        # (C,2N) products in device memory between the matmul and the
        # reduction.  Elementwise broadcasts fuse into one pass with the
        # quadratic + reduction.
        cd = (c[:, 0:1] * d[None, :, 0] + c[:, 1:2] * d[None, :, 1]
              + c[:, 2:3] * d[None, :, 2])                 # (C,N)
        co = (c[:, 0:1] * o[None, :, 0] + c[:, 1:2] * o[None, :, 1]
              + c[:, 2:3] * o[None, :, 2])                 # (C,N)
        half_b = od[None, :] - cd                          # (C,N)
        c_term = (oo[None, :] - 2.0 * co) + cc_rr[:, None]
        disc = half_b * half_b - a[None, :] * c_term
        # r != 0 excludes chunk-padding spheres: a radius-0 sphere at
        # the pad origin still scores a tangent "hit" (disc == 0) for
        # any ray whose line passes exactly through it, handing the
        # winner a phantom index.
        ok = (disc >= 0.0) & (r != 0.0)[:, None]
        # where-before-sqrt: sqrt'(0)=inf would NaN the backward pass of
        # differentiable renders even though misses are masked out.
        sq = jnp.sqrt(jnp.where(ok, jnp.maximum(disc, 0.0), 1.0))
        inv_a = 1.0 / a[None, :]
        root0 = (-half_b - sq) * inv_a
        root1 = (-half_b + sq) * inv_a
        lim = jnp.minimum(best_t, t_max)[None, :]
        ok0 = ok & (root0 >= t_min) & (root0 <= lim)
        ok1 = ok & (root1 >= t_min) & (root1 <= lim)
        root = jnp.where(ok0, root0, jnp.where(ok1, root1, INF))
        ct = jnp.min(root, axis=0)                          # (N,)
        ci = jnp.argmin(root, axis=0).astype(jnp.int32) + b0
        better = ct < best_t
        return (jnp.where(better, ct, best_t),
                jnp.where(better, ci, best_i)), None

    # Derive the carry init from ray data so it inherits the rays'
    # varying-axes type under shard_map (fresh zeros would not).
    init = (jnp.full_like(od, INF), jnp.zeros_like(od, dtype=jnp.int32))
    (best_t, best_i), _ = jax.lax.scan(body, init, (centers, radii, base))
    return best_t, best_i


def make_hits(spheres: Spheres, o, d, t, index) -> Hits:
    """Expand (t, index) from nearest_t into a full Hits record."""
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    index = jnp.clip(index, 0, spheres.count - 1)
    c = spheres.center[index]
    r = spheres.radius[index]
    material = spheres.material[index]
    point = o + d * t_safe[:, None]
    outward = (point - c) / r[:, None]
    normal, front_face = set_face_normal(d, outward)
    return Hits(
        t=jnp.where(hit, t, INF),
        point=point,
        normal=normal,
        front_face=front_face,
        uv=jnp.zeros((o.shape[0], 2), jnp.float32),  # spheres carry no UVs
        material=material,
        hit=hit,
        tangent=jnp.zeros_like(point),
        bitangent=jnp.zeros_like(point),
        prim_area=jnp.where(hit, -r, 0.0),  # <0 = sphere (MIS pdf)
    )


def intersect(spheres: Spheres, o, d, t_min, t_max) -> Hits:
    """Closest sphere hit per ray: the chunk scan plus winner expansion."""
    t, index = nearest_t(spheres, o, d, t_min, t_max)
    return make_hits(spheres, o, d, t, index)
