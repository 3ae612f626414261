"""A tiny NumPy re-implementation of the reference's exact algorithms.

Golden oracle for correctness tests (SURVEY §7 step 2): implements
`Camera::trace` (reference: src/world.rs:65-79) recursively per ray with
the reference's material semantics (src/material.rs) on spheres
(src/geom.rs:57-93).  Monte Carlo means from this tracer and from the
wavefront integrator must agree within sampling error — the RNGs differ
by design, only the *distributions* match.
"""

from __future__ import annotations

import numpy as np

T_MIN = 1e-3


def _unit(v):
    return v / np.linalg.norm(v)


class RefMaterials:
    """Scatter/emit following material.rs exactly (scalar, one ray)."""

    def __init__(self, table, rng):
        # table: mrt MaterialTable-like (numpy views)
        self.mtype = np.asarray(table.mtype)
        self.albedo = np.asarray(table.albedo)
        self.fuzz = np.asarray(table.fuzz)
        self.ior = np.asarray(table.ior)
        self.emit_v = np.asarray(table.emit)
        self.mix_ratio = np.asarray(table.mix_ratio)
        self.mix_left = np.asarray(table.mix_left)
        self.mix_right = np.asarray(table.mix_right)
        self.rng = rng

    # -- samplers matching math.rs:80-109 ---------------------------------
    def random_in_unit_sphere(self):
        while True:
            p = self.rng.uniform(-1, 1, 3)
            if p @ p < 1.0:
                return p

    def random_unit_vector(self):
        return _unit(self.random_in_unit_sphere())

    def resolve(self, m):
        # Mix: fresh rand per call (material.rs:402-407)
        while self.mtype[m] == 6:  # MIX
            if self.rng.random() < self.mix_ratio[m]:
                m = self.mix_left[m]
            else:
                m = self.mix_right[m]
        return m

    def emitted(self, m):
        m = self.resolve(m)
        if self.mtype[m] == 3:  # DIFFUSE_LIGHT
            return self.emit_v[m].copy()
        return np.zeros(3)

    def scatter(self, m, d, point, normal, front_face):
        """Returns (attenuation, new_dir) or None."""
        m = self.resolve(m)
        t = self.mtype[m]
        if t == 0:  # LAMBERTIAN (material.rs:204-220)
            nd = normal + self.random_unit_vector()
            if np.all(np.abs(nd) <= 1e-5):
                nd = normal
            return self.albedo[m, :3].copy(), nd
        if t == 1:  # METAL (material.rs:261-284)
            ud = _unit(d)
            refl = ud - 2.0 * (ud @ normal) * normal
            nd = refl + self.fuzz[m] * self.random_in_unit_sphere()
            if nd @ normal > 0:
                return self.albedo[m, :3].copy(), nd
            return None
        if t == 2 or t == 5:  # DIELECTRIC / SPECULAR (material.rs:302-383)
            ratio = 1.0 / self.ior[m] if front_face else self.ior[m]
            ud = _unit(d)
            cos_t = min(-(ud @ normal), 1.0)
            sin_t = np.sqrt(max(0.0, 1.0 - cos_t * cos_t))
            r0 = ((1 - ratio) / (1 + ratio)) ** 2
            schlick = r0 + (1 - r0) * (1 - cos_t) ** 5
            if ratio * sin_t > 1.0 or schlick > self.rng.random():
                nd = ud - 2.0 * (ud @ normal) * normal
                return np.ones(3), nd
            if t == 5:  # Specular falls back to inner Lambertian
                nd = normal + self.random_unit_vector()
                if np.all(np.abs(nd) <= 1e-5):
                    nd = normal
                return self.albedo[m, :3].copy(), nd
            r_perp = (ud + normal * cos_t) * ratio
            r_par = -np.sqrt(abs(1.0 - r_perp @ r_perp)) * normal
            return np.ones(3), r_perp + r_par
        if t == 4:  # ISOTROPIC (material.rs:438-445)
            return self.albedo[m, :3].copy(), self.random_in_unit_sphere()
        return None  # DIFFUSE_LIGHT / NULL


def intersect_spheres(centers, radii, mats, o, d, t_min=T_MIN):
    """Closest sphere hit, root selection per geom.rs:57-93."""
    best = None
    t_best = np.inf
    for c, r, m in zip(centers, radii, mats):
        oc = o - c
        a = d @ d
        half_b = oc @ d
        cterm = oc @ oc - r * r
        disc = half_b * half_b - a * cterm
        if disc < 0:
            continue
        sq = np.sqrt(disc)
        root = (-half_b - sq) / a
        if root < t_min or root > t_best:
            root = (-half_b + sq) / a
            if root < t_min or root > t_best:
                continue
        t_best = root
        point = o + d * root
        outward = (point - c) / r
        ff = d @ outward < 0
        normal = outward if ff else -outward
        best = (root, point, normal, ff, m)
    return best


def sky_background(d):
    u = _unit(d)
    t = 0.5 * (u[1] + 1.0)
    return (1 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0])


def trace(mats: RefMaterials, centers, radii, mat_ids, o, d, depth,
          background=sky_background):
    """world.rs:65-79 verbatim."""
    if depth == 0:
        return np.zeros(3)
    hit = intersect_spheres(centers, radii, mat_ids, o, d)
    if hit is None:
        return background(d)
    t, point, normal, ff, m = hit
    emitted = mats.emitted(m)
    sc = mats.scatter(m, d, point, normal, ff)
    if sc is None:
        return emitted
    atten, nd = sc
    return trace(mats, centers, radii, mat_ids, point, nd,
                 depth - 1, background) * atten + emitted


def background_of(scene):
    """Derive the oracle background function from the scene's background."""
    bg = scene.background
    name = type(bg).__name__
    if name == "SolidBackground":
        color = np.asarray(bg.color)
        return lambda d: color.copy()
    if name == "SkyBackground":
        return sky_background
    raise NotImplementedError(name)


def render(scene, camera_rays, width, height, spp, max_depth, seed=0,
           background=None):
    """Render mean image with pixel jitter; camera_rays(s, t) -> (o, d)."""
    if background is None:
        background = background_of(scene)
    rng = np.random.default_rng(seed)
    centers = np.asarray(scene.spheres.center)
    radii = np.asarray(scene.spheres.radius)
    mat_ids = np.asarray(scene.spheres.material)
    mats = RefMaterials(scene.materials, rng)
    img = np.zeros((height, width, 3))
    for y in range(height):
        for x in range(width):
            acc = np.zeros(3)
            for _ in range(spp):
                s = (x + rng.random()) / width
                t = (y + rng.random()) / height
                o, d = camera_rays(s, t)
                acc += trace(mats, centers, radii, mat_ids, o, d, max_depth,
                             background)
            img[y, x] = acc / spp
    return img
