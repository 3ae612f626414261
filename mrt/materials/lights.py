"""Explicit light sampling (next-event estimation) — beyond-reference.

The reference's integrator is pure BSDF sampling (reference:
world.rs:65-79): paths find lights only by chance, which converges very
slowly for small area lights (the Cornell ceiling panel) or distant
suns.  This module adds an *opt-in* light table + NEE sampling:

  - triangle lights (area-sampled with the geometry term) collected
    from emissive mesh triangles, baked to world space per instance;
  - sphere lights sampled by the subtended cone (solid-angle pdf), the
    right strategy for huge distant suns (scenes/lucy.rs sun);
  - a one-sample uniform light pick per NEE-capable vertex (any vertex
    that scattered through a cosine lobe — Lambertian and the
    Lambertian arms of Specular/EVE — or the isotropic volume phase);
  - multiple importance sampling (power heuristic, beta=2) between the
    light sample and the BSDF continuation: the light sample is scaled
    by p_L^2/(p_L^2+p_B^2) and emission found by the continuation ray
    by p_B^2/(p_B^2+p_L^2), so the pair stays a partition of unity and
    the estimator is unbiased with lower variance than either strategy
    or the round-1 "split" convention (which zeroed BSDF-found emission
    after an NEE vertex entirely).

The cosine-lobe pdf uses the *unit* shading normal; mesh smooth normals
are unnormalised (reference quirk, geom.rs:552), so for those the
weights are an approximate-but-consistent partition of unity — still
unbiased, as MIS only needs the two weights to sum to 1.

Renders with a light table attached are a *different estimator* with
the same expectation — goldens and reference-parity tests use scenes
without one.  Enable via SceneBuilder.build(nee=True) or
`attach_lights(scene)`.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..utils import struct

from ..math import vec

SPHERE = 0
TRI = 1

TAU = 2.0 * np.pi


@struct.dataclass
class LightTable:
    kind: jnp.ndarray      # (L,) SPHERE | TRI
    p0: jnp.ndarray        # (L,3) sphere center / tri vertex a
    e1: jnp.ndarray        # (L,3) tri edge ab (zeros for spheres)
    e2: jnp.ndarray        # (L,3) tri edge ac
    radius: jnp.ndarray    # (L,) sphere radius
    emission: jnp.ndarray  # (L,3)
    area: jnp.ndarray      # (L,) tri area (G-term pdf)

    @property
    def count(self):
        return self.kind.shape[0]


def collect_lights(scene) -> LightTable | None:
    """Host-side: harvest emissive geometry into a LightTable."""
    from ..materials import table as T

    mtype = np.asarray(scene.materials.mtype)
    emit = np.asarray(scene.materials.emit)

    kinds, p0s, e1s, e2s, radii, ems, areas = [], [], [], [], [], [], []

    def is_light(rows):
        return mtype[rows] == T.DIFFUSE_LIGHT

    if scene.spheres is not None:
        rows = np.asarray(scene.spheres.material)
        mask = is_light(rows)
        for c, r, m in zip(np.asarray(scene.spheres.center)[mask],
                           np.asarray(scene.spheres.radius)[mask],
                           rows[mask]):
            kinds.append(SPHERE)
            p0s.append(c)
            e1s.append(np.zeros(3))
            e2s.append(np.zeros(3))
            radii.append(r)
            ems.append(emit[m])
            areas.append(0.0)

    def add_tris(va, e1, e2, rows):
        mask = is_light(rows)
        for a, b, c, m in zip(va[mask], e1[mask], e2[mask], rows[mask]):
            kinds.append(TRI)
            p0s.append(a)
            e1s.append(b)
            e2s.append(c)
            radii.append(0.0)
            ems.append(emit[m])
            areas.append(0.5 * np.linalg.norm(np.cross(b, c)))

    if scene.triangles is not None:
        tr = scene.triangles
        add_tris(np.asarray(tr.va), np.asarray(tr.e_ab),
                 np.asarray(tr.e_ac), np.asarray(tr.material))

    if scene.tlas is not None:
        tl = scene.tlas
        tris = tl.tris
        va = np.asarray(tris.va)
        e1 = np.asarray(tris.e_ab)
        e2 = np.asarray(tris.e_ac)
        tri_mat = np.asarray(tris.material)
        fwd = np.asarray(tl.transform)
        override = np.asarray(tl.override)
        roots = np.asarray(tl.blas_root)
        firsts = np.asarray(tl.first)
        counts = np.asarray(tl.count)
        escapes = np.asarray(tl.escape)
        ends = np.asarray(tl.blas_end)
        for inst in range(fwd.shape[0]):
            # Triangle range of this instance's mesh: leaves between
            # root and end.
            lo, hi = roots[inst], ends[inst]
            leaf = counts[lo:hi] > 0
            if not leaf.any():
                continue
            f = firsts[lo:hi][leaf]
            c = counts[lo:hi][leaf]
            idx = np.concatenate([np.arange(a, a + b)
                                  for a, b in zip(f, c)])
            rows = (np.full(idx.shape, override[inst], np.int64)
                    if override[inst] >= 0 else tri_mat[idx])
            mask = is_light(rows)
            if not mask.any():
                continue
            m3 = fwd[inst, :3, :3]
            t3 = fwd[inst, :3, 3]
            add_tris(va[idx][mask] @ m3.T + t3,
                     e1[idx][mask] @ m3.T, e2[idx][mask] @ m3.T,
                     rows[mask])

    if not kinds:
        return None
    return LightTable(
        kind=jnp.asarray(np.array(kinds, np.int32)),
        p0=jnp.asarray(np.array(p0s, np.float32)),
        e1=jnp.asarray(np.array(e1s, np.float32)),
        e2=jnp.asarray(np.array(e2s, np.float32)),
        radius=jnp.asarray(np.array(radii, np.float32)),
        emission=jnp.asarray(np.array(ems, np.float32)),
        area=jnp.asarray(np.array(areas, np.float32)))


def bsdf_pdf(lobe, n_unit, w):
    """Solid-angle pdf of the scatter lobe for direction w.

    lobe: 0 none, 1 cosine (pdf cos/pi over the hemisphere), 2 isotropic
    (1/4pi).  Used on both sides of the MIS weights, so it only needs to
    be consistent, not exact (see module docstring).
    """
    cos_p = jnp.sum(w * n_unit, axis=-1)
    pdf_cos = jnp.maximum(cos_p, 0.0) / jnp.pi
    return jnp.where(lobe == 1, pdf_cos,
                     jnp.where(lobe == 2, 1.0 / (2.0 * TAU), 0.0))


def sample_direct(scene, hits, sampler, lobe=None):
    """One-sample MIS-weighted NEE at NEE-capable vertices.

    Returns (direct (N,3) radiance-to-multiply-by-throughput-and-albedo,
    did_nee (N,) bool).  `direct` already includes the lobe's f-term
    (cos/pi cosine lobe, 1/4pi isotropic phase), the geometry/
    solid-angle pdf, the light-pick probability and the MIS weight;
    multiply by the vertex albedo and path throughput.

    lobe: per-ray scatter lobe from shade.shade_hit; None falls back to
    "Lambertian rows only" (the round-1 convention) with no MIS.
    """
    from ..materials import table as T

    lights = scene.lights
    L = lights.count
    n = hits.material.shape[0]
    if lobe is None:
        from .shade import _icol, _rows_of
        mtype = _icol(_rows_of(scene.materials, hits.material),
                      T.MaterialTable.C_MTYPE)
        lobe = jnp.where(mtype == T.LAMBERTIAN, 1, 0)
        mis = False
    else:
        mis = True
    capable = hits.hit & (lobe > 0)

    u_pick, u1, u2, _ = sampler.next4()
    li = jnp.minimum((u_pick * L).astype(jnp.int32), L - 1)

    kind = lights.kind[li]
    p0 = lights.p0[li]
    e1 = lights.e1[li]
    e2 = lights.e2[li]
    radius = lights.radius[li]
    emission = lights.emission[li]
    area = lights.area[li]

    p = hits.point
    nrm = hits.normal
    n_unit = nrm / jnp.maximum(
        jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)

    # --- triangle lights: uniform area sample + G term ------------------
    su = jnp.sqrt(jnp.maximum(u1, 1e-12))
    b1 = 1.0 - su
    b2 = u2 * su
    x_tri = p0 + e1 * b1[:, None] + e2 * b2[:, None]
    tri_n = jnp.cross(e1, e2)
    tri_n = tri_n / jnp.maximum(
        jnp.linalg.norm(tri_n, axis=-1, keepdims=True), 1e-20)

    to_tri = x_tri - p
    dist2_tri = jnp.sum(to_tri * to_tri, axis=-1)
    dist_tri = jnp.sqrt(jnp.maximum(dist2_tri, 1e-12))
    w_tri = to_tri / dist_tri[:, None]
    cos_p_tri = jnp.sum(w_tri * n_unit, axis=-1)
    cos_l_tri = jnp.abs(jnp.sum(w_tri * tri_n, axis=-1))
    # f/pdf for area sampling: f * cos_l * area / dist^2, where f is the
    # lobe's BRDF-with-cos over albedo: cos_p/pi (cosine) or 1/4pi.
    f_tri = jnp.where(lobe == 2, 1.0 / (2.0 * TAU), cos_p_tri / jnp.pi)
    weight_tri = (f_tri * cos_l_tri * area
                  / jnp.maximum(dist2_tri, 1e-12))
    # Solid-angle pdf of this light sample (for the MIS weight).
    psa_tri = dist2_tri / jnp.maximum(cos_l_tri * area, 1e-12)

    # --- sphere lights: cone (solid-angle) sampling ---------------------
    to_c = p0 - p
    dist_c = jnp.sqrt(jnp.maximum(jnp.sum(to_c * to_c, axis=-1), 1e-12))
    # Clamp: shading point inside the light => no NEE contribution.
    sin_max = jnp.clip(radius / dist_c, 0.0, 1.0)
    cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_max * sin_max))
    axis = to_c / dist_c[:, None]
    # Orthonormal basis around the axis.
    h = jnp.where(jnp.abs(axis[:, 0:1]) > 0.9,
                  jnp.asarray([0.0, 1.0, 0.0]),
                  jnp.asarray([1.0, 0.0, 0.0]))
    t1 = jnp.cross(axis, jnp.broadcast_to(h, axis.shape))
    t1 = t1 / jnp.maximum(jnp.linalg.norm(t1, axis=-1, keepdims=True),
                          1e-20)
    t2 = jnp.cross(axis, t1)
    cos_theta = 1.0 - u1 * (1.0 - cos_max)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = TAU * u2
    w_sph = (axis * cos_theta[:, None]
             + t1 * (sin_theta * jnp.cos(phi))[:, None]
             + t2 * (sin_theta * jnp.sin(phi))[:, None])
    cos_p_sph = jnp.sum(w_sph * n_unit, axis=-1)
    solid_angle = TAU * (1.0 - cos_max)
    # f/pdf for solid-angle sampling: f * solid_angle.
    f_sph = jnp.where(lobe == 2, 1.0 / (2.0 * TAU), cos_p_sph / jnp.pi)
    weight_sph = f_sph * solid_angle
    psa_sph = 1.0 / jnp.maximum(solid_angle, 1e-12)
    # Distance to the sphere along w (for the shadow-ray clip): the
    # near intersection of the cone sample direction.
    b_q = jnp.sum(w_sph * (-to_c), axis=-1)
    c_q = jnp.sum(to_c * to_c, axis=-1) - radius * radius
    disc_q = jnp.maximum(b_q * b_q - c_q, 0.0)
    dist_sph = jnp.maximum(-b_q - jnp.sqrt(disc_q), 1e-3)

    is_tri = kind == TRI
    w = jnp.where(is_tri[:, None], w_tri, w_sph)
    weight = jnp.where(is_tri, weight_tri, weight_sph)
    dist = jnp.where(is_tri, dist_tri, dist_sph)

    valid = capable & (weight > 0.0)

    if mis:
        p_light = jnp.where(is_tri, psa_tri, psa_sph) / float(L)
        p_b = bsdf_pdf(lobe, n_unit, w)
        w_mis = (p_light * p_light
                 / jnp.maximum(p_light * p_light + p_b * p_b, 1e-20))
        weight = weight * w_mis

    # Shadow ray: any blocker strictly before the light point?
    shadow_hits = scene.intersect(
        p, w, t_min=1e-3,
        t_max=jnp.where(valid, dist - 1e-3, 1e-3),
        sampler=sampler, shading_aux=False)
    unoccluded = ~shadow_hits.hit

    direct = (emission * (weight * float(L))[:, None]
              * (valid & unoccluded)[:, None])
    return direct, valid


def mis_bsdf_weight(scene, hits, o, d, prev_pdf):
    """Power-heuristic weight for emission found by the BSDF
    continuation of an NEE-capable vertex.

    o, d: the continuation ray (origin = the previous vertex);
    prev_pdf: the solid-angle pdf of choosing d at that vertex (0 when
    the vertex did no NEE — then the caller keeps full emission).
    Reconstructs the pdf with which light sampling at o would have
    generated this direction from the hit geometry (Hits.prim_area:
    world tri area, or -radius for spheres).
    """
    lights = scene.lights
    L = float(lights.count)

    d_len = jnp.maximum(jnp.linalg.norm(d, axis=-1), 1e-20)
    w = d / d_len[:, None]
    t_safe = jnp.where(hits.hit, hits.t, 1.0)
    dist = t_safe * d_len
    outward = hits.outward_normal
    out_unit = outward / jnp.maximum(
        jnp.linalg.norm(outward, axis=-1, keepdims=True), 1e-20)

    # Triangle light: area pdf -> solid angle.
    cos_l = jnp.abs(jnp.sum(w * out_unit, axis=-1))
    area = jnp.maximum(hits.prim_area, 0.0)
    psa_tri = dist * dist / jnp.maximum(cos_l * area, 1e-12)

    # Sphere light: cone solid-angle pdf from the previous vertex.
    r = jnp.maximum(-hits.prim_area, 0.0)
    center = hits.point - out_unit * r[:, None]
    to_c = center - o
    dist_c = jnp.maximum(jnp.linalg.norm(to_c, axis=-1), 1e-12)
    sin_max = jnp.clip(r / dist_c, 0.0, 1.0)
    cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_max * sin_max))
    solid = TAU * (1.0 - cos_max)
    psa_sph = 1.0 / jnp.maximum(solid, 1e-12)

    p_light = jnp.where(hits.prim_area > 0.0, psa_tri,
                        jnp.where(hits.prim_area < 0.0, psa_sph,
                                  0.0)) / L
    return (prev_pdf * prev_pdf
            / jnp.maximum(prev_pdf * prev_pdf + p_light * p_light,
                          1e-20))
