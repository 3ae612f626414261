"""Batched ray-triangle intersection (Möller–Trumbore).

The reference intersects one `Triangle<M>` at a time through virtual
dispatch (reference: src/geom.rs:504-592).  Here all T triangles live in
SoA arrays and a wavefront of N rays tests triangle chunks in a
`lax.scan` carrying the per-ray best (t, index, u, v); interpolation and
shading data are gathered once for the winning triangle only.

Semantics matched to the reference:
  - det epsilon 1e-6 rejects parallel rays     (geom.rs:510-513)
  - barycentric smooth normal, NOT renormalised (geom.rs:536-552)
  - UV interpolation with the same weights      (geom.rs:554-556)
  - tangent/bitangent from UV deltas at build, r clamped to [-1,1]
                                                (geom.rs:468-496)
  - per-triangle has_uv flag (None uvs -> no uv, geom.rs:432-436)
  - flat normal fallback = unit(ab x ac)        (geom.rs:449-466)

Normal mapping + alpha testing hook in at the scene level once textures
are present (geom.rs:554-571); see mrt.materials.shade.alpha_test.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from .hit import Hits, set_face_normal, INF

# Triangles per scan chunk: the (CHUNK, N, 3) cross-product temporaries
# bound memory; brute force is for small meshes (BVH covers big ones).
CHUNK = 64

DET_EPS = 1e-6  # geom.rs:513


@struct.dataclass
class Triangles:
    va: jnp.ndarray         # (T,3) vertex a
    e_ab: jnp.ndarray       # (T,3) vertex_b - vertex_a
    e_ac: jnp.ndarray       # (T,3) vertex_c - vertex_a
    na: jnp.ndarray         # (T,3) vertex normals (flat normal if none)
    nb: jnp.ndarray         # (T,3)
    nc: jnp.ndarray         # (T,3)
    uva: jnp.ndarray        # (T,2)
    uvb: jnp.ndarray        # (T,2)
    uvc: jnp.ndarray        # (T,2)
    tangent: jnp.ndarray    # (T,3)
    bitangent: jnp.ndarray  # (T,3)
    material: jnp.ndarray   # (T,)  int32
    has_uv: jnp.ndarray     # (T,)  bool
    # Static: normalise the interpolated smooth normal at hit time.
    # Plain triangles keep the reference's UNnormalised smooth normal
    # (geom.rs:552); world-flattened instanced triangles must instead
    # match the instanced path, which renormalises after the forward
    # linear transform (geom.rs:412, instance.expand_winner).
    unit_normal: bool = struct.field(pytree_node=False, default=False)

    @property
    def count(self):
        return self.va.shape[0]

    @classmethod
    def build(cls, vertices, faces, normals=None, uvs=None, material=0):
        """Host-side constructor from indexed mesh data.

        Args:
          vertices: (V,3) float array.
          faces: (T,3) int array of vertex indices.
          normals: optional (V,3) per-vertex normals; None -> flat.
          uvs: optional (V,2) per-vertex UVs.
          material: scalar or (T,) material row ids.
        """
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        va = vertices[faces[:, 0]]
        vb = vertices[faces[:, 1]]
        vc = vertices[faces[:, 2]]
        return cls.from_soup(va, vb, vc,
                             normals=None if normals is None else (
                                 np.asarray(normals, np.float32)[faces[:, 0]],
                                 np.asarray(normals, np.float32)[faces[:, 1]],
                                 np.asarray(normals, np.float32)[faces[:, 2]]),
                             uvs=None if uvs is None else (
                                 np.asarray(uvs, np.float32)[faces[:, 0]],
                                 np.asarray(uvs, np.float32)[faces[:, 1]],
                                 np.asarray(uvs, np.float32)[faces[:, 2]]),
                             material=material)

    @classmethod
    def from_soup(cls, va, vb, vc, normals=None, uvs=None, material=0):
        """Host-side constructor from a triangle soup (per-corner data).

        normals/uvs: optional (na, nb, nc) / (uva, uvb, uvc) tuples.
        """
        va = np.asarray(va, np.float32)
        vb = np.asarray(vb, np.float32)
        vc = np.asarray(vc, np.float32)
        t = va.shape[0]
        ab = vb - va
        ac = vc - va

        flat = np.cross(ab, ac)
        norm = np.linalg.norm(flat, axis=-1, keepdims=True)
        flat = flat / np.maximum(norm, 1e-20)

        if normals is None:
            na = nb = nc = flat
        else:
            na, nb, nc = (np.asarray(x, np.float32) for x in normals)

        if uvs is None:
            uva = uvb = uvc = np.zeros((t, 2), np.float32)
            has_uv = np.zeros((t,), bool)
            tangent = np.zeros((t, 3), np.float32)
            bitangent = np.zeros((t, 3), np.float32)
        else:
            uva, uvb, uvc = (np.asarray(x, np.float32) for x in uvs)
            has_uv = np.ones((t,), bool)
            # Tangent frame from UV deltas (geom.rs:475-482), r clamped.
            uv_ab = uvb - uva
            uv_ac = uvc - uva
            denom = (uv_ab[:, 0] * uv_ac[:, 1]
                     - uv_ab[:, 1] * uv_ac[:, 0])
            with np.errstate(divide="ignore", invalid="ignore"):
                r = np.clip(1.0 / denom, -1.0, 1.0)
            r = np.nan_to_num(r, nan=1.0, posinf=1.0, neginf=-1.0)
            tangent = (ab * uv_ac[:, 1:2] - ac * uv_ab[:, 1:2]) * r[:, None]
            bitangent = (ac * uv_ab[:, 0:1] - ab * uv_ac[:, 0:1]) * r[:, None]

        material = np.ascontiguousarray(
            np.broadcast_to(np.asarray(material, np.int32), (t,)))
        # Leaves stay NumPy: mesh construction, BVH builds and scene
        # assembly all happen on host; SceneBuilder/MeshRegistry convert
        # to device arrays exactly once at build() (jit auto-converts any
        # that reach device code directly).  Keeping jnp here made every
        # scene generate() dispatch dozens of tiny remote ops.
        return cls(va=va, e_ab=ab, e_ac=ac,
                   na=na, nb=nb, nc=nc,
                   uva=uva, uvb=uvb, uvc=uvc,
                   tangent=tangent, bitangent=bitangent,
                   material=material, has_uv=has_uv)


def _pad_to(x, n, fill=0.0):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths, constant_values=fill)


def nearest_hit(tris: Triangles, o, d, t_min, t_max):
    """Closest valid triangle per ray.

    Returns (t (N,), index (N,), u (N,), v (N,)): t=+inf on miss,
    (u, v) the Möller–Trumbore barycentrics of the winner.
    """
    n = o.shape[0]
    t_cnt = tris.count
    chunk = min(CHUNK, max(8, t_cnt))
    t_pad = ((t_cnt + chunk - 1) // chunk) * chunk
    k = t_pad // chunk

    # Padded triangles are degenerate (zero edges) => det 0 => rejected.
    va = _pad_to(tris.va, t_pad).reshape(k, chunk, 3)
    ab = _pad_to(tris.e_ab, t_pad).reshape(k, chunk, 3)
    ac = _pad_to(tris.e_ac, t_pad).reshape(k, chunk, 3)
    base = jnp.arange(k, dtype=jnp.int32) * chunk

    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    def body(carry, chunk_in):
        best_t, best_i, best_u, best_v = carry
        cva, cab, cac, b0 = chunk_in
        # p_vec = d x ac           (C,N,3)
        p = jnp.cross(d[None, :, :], cac[:, None, :])
        det = jnp.sum(cab[:, None, :] * p, axis=-1)          # (C,N)
        det_ok = jnp.abs(det) >= DET_EPS
        # Masked reciprocal keeps backward passes NaN-free.
        inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
        tv = o[None, :, :] - cva[:, None, :]                 # (C,N,3)
        u = jnp.sum(tv * p, axis=-1) * inv_det
        q = jnp.cross(tv, cab[:, None, :])                   # (C,N,3)
        v = jnp.sum(d[None, :, :] * q, axis=-1) * inv_det
        t = jnp.sum(cac[:, None, :] * q, axis=-1) * inv_det

        lim = jnp.minimum(best_t, t_max)[None, :]
        ok = (det_ok
              & (u >= 0.0) & (u <= 1.0)
              & (v >= 0.0) & (u + v <= 1.0)
              & (t >= t_min) & (t <= lim))
        t = jnp.where(ok, t, INF)
        ct = jnp.min(t, axis=0)                              # (N,)
        sel = jnp.argmin(t, axis=0)                          # (N,)
        ci = sel.astype(jnp.int32) + b0
        cu = jnp.take_along_axis(u, sel[None, :], axis=0)[0]
        cv = jnp.take_along_axis(v, sel[None, :], axis=0)[0]
        better = ct < best_t
        return (jnp.where(better, ct, best_t),
                jnp.where(better, ci, best_i),
                jnp.where(better, cu, best_u),
                jnp.where(better, cv, best_v)), None

    od = jnp.sum(o * d, axis=-1)  # varying-typed seed for carry inits
    init = (jnp.full_like(od, INF),
            jnp.zeros_like(od, dtype=jnp.int32),
            jnp.zeros_like(od),
            jnp.zeros_like(od))
    (best_t, best_i, best_u, best_v), _ = jax.lax.scan(
        body, init, (va, ab, ac, base))
    return best_t, best_i, best_u, best_v


def shading_table(tris: Triangles):
    """Per-triangle shading data packed into ONE (T, 29) f32 table,
    so a winner expansion reads one row per ray instead of gathering
    12 separate arrays.  Columns: na nb nc (9), uva uvb uvc (6), has_uv (1), material (1),
    tangent bitangent (6), e_ab e_ac (6)."""
    return jnp.concatenate(
        [tris.na, tris.nb, tris.nc,
         tris.uva, tris.uvb, tris.uvc,
         tris.has_uv.astype(jnp.float32)[:, None],
         tris.material.astype(jnp.float32)[:, None],
         tris.tangent, tris.bitangent,
         tris.e_ab, tris.e_ac], axis=-1)


def unpack_shading(row):
    """Split a (N, 29) shading_table lookup into named parts."""
    return dict(
        na=row[:, 0:3], nb=row[:, 3:6], nc=row[:, 6:9],
        uva=row[:, 9:11], uvb=row[:, 11:13], uvc=row[:, 13:15],
        has_uv=row[:, 15] > 0.5,
        material=jnp.round(row[:, 16]).astype(jnp.int32),
        tangent=row[:, 17:20], bitangent=row[:, 20:23],
        e_ab=row[:, 23:26], e_ac=row[:, 26:29])


def make_hits(tris: Triangles, o, d, t, index, u, v) -> Hits:
    """Expand winner (t, index, u, v) into a full Hits record.

    Smooth normal/UV use barycentric weights (1-u-v, u, v) — identical to
    the reference's areal weights (geom.rs:536-552) for points on the
    triangle plane.  Normal is NOT renormalised, matching geom.rs:552.
    """
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    point = o + d * t_safe[:, None]
    w = (1.0 - u - v)[:, None]
    uu, vv = u[:, None], v[:, None]

    s = unpack_shading(shading_table(tris)[index])
    normal = s["na"] * w + s["nb"] * uu + s["nc"] * vv
    uv = s["uva"] * w + s["uvb"] * uu + s["uvc"] * vv
    uv = jnp.where(s["has_uv"][:, None], uv, 0.0)
    if tris.unit_normal:
        # World-flattened instanced triangles: same normalisation as
        # instance.expand_winner (the linear transform is baked into
        # the per-vertex normals, so normalise(interp) here equals
        # normalise(lin @ interp_obj) there).
        norm = jnp.sqrt(jnp.sum(normal * normal, axis=-1,
                                keepdims=True))
        normal = normal / jnp.maximum(norm, 1e-20)
    normal, front_face = set_face_normal(d, normal)
    area = 0.5 * jnp.linalg.norm(
        jnp.cross(s["e_ab"], s["e_ac"]), axis=-1)
    return Hits(
        t=jnp.where(hit, t, INF),
        point=point,
        normal=normal,
        front_face=front_face,
        uv=uv,
        material=s["material"],
        hit=hit,
        tangent=s["tangent"],
        bitangent=s["bitangent"],
        prim_area=jnp.where(hit, area, 0.0),
    )


def intersect_brute(tris: Triangles, o, d, t_min, t_max, scene=None) -> Hits:
    import jax
    tris = jax.tree.map(jnp.asarray, tris)  # host meshes -> device
    t, index, u, v = nearest_hit(tris, o, d, t_min, t_max)
    return make_hits(tris, o, d, t, index, u, v)
