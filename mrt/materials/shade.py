"""Branch-free batched material shading.

The reference dispatches `&dyn Material::scatter/emit` per ray
(reference: src/material.rs:15-27, src/world.rs:65-79).  Here one call
shades a whole wavefront: every material class is evaluated for every ray
and the per-ray result is selected by the hit's material row — no sort
by material for the small class count (8).

Semantics matched to the reference:
  Lambertian  normal + random_unit_vector, degenerate->normal
              (material.rs:204-220)
  Metal       reflect(unit(d)) + fuzz*in_unit_sphere, absorb when the
              scattered direction leaves below the surface
              (material.rs:261-284)
  Dielectric  stochastic Schlick Fresnel, reflect on TIR, attenuation 1
              (material.rs:296-329)
  DiffuseLight no scatter, constant emission (material.rs:238-246)
  Isotropic   uniform-ball scatter (material.rs:438-445)
  Specular    Fresnel-gated mirror else inner Lambertian
              (material.rs:352-383)
  Mix         stochastic select of two rows, independent re-roll per
              method exactly like the reference's per-call `f32::rand()`
              (material.rs:402-426)
  Null        never scatters (material.rs:385-389)
"""

from __future__ import annotations

import jax.numpy as jnp

from ..math import vec, sampling
from . import table as T


def _rows_of(materials, rows):
    """One packed-material row read per lane (identical calls CSE
    inside a jitted step)."""
    return materials.packed[rows]


def sample_tex(scene, ids, uv, need=None):
    """Atlas sample for a wavefront; with `need`, zeros on the lanes
    that do not consume the value."""
    s = scene.atlas.sample(jnp.maximum(ids, 0), uv, raw=scene.mat_tex_raw)
    return s if need is None else jnp.where(need[:, None], s, 0.0)


def _icol(packed_rows, col):
    return jnp.round(packed_rows[:, col]).astype(jnp.int32)


def resolve_mix(materials: T.MaterialTable, rows, u_draws):
    """Resolve MIX rows to concrete rows with pre-drawn uniforms.

    ``u_draws`` is a list of MAX_MIX_DEPTH uniform arrays (rows-shaped);
    each nesting level consumes one, mirroring the reference's fresh
    `f32::rand()` per Mix level (material.rs:403-407).  Only the
    table's actual nesting depth is iterated (bit-exact: further
    levels map rows to themselves) — each elided level saves a
    full-table one-hot fetch.
    """
    for u in u_draws[:getattr(materials, "mix_depth",
                              T.MAX_MIX_DEPTH)]:
        m = _rows_of(materials, rows)
        is_mix = _icol(m, T.MaterialTable.C_MTYPE) == T.MIX
        pick_left = u < m[:, T.MaterialTable.C_MIX_RATIO]
        resolved = jnp.where(pick_left,
                             _icol(m, T.MaterialTable.C_MIX_LEFT),
                             _icol(m, T.MaterialTable.C_MIX_RIGHT))
        rows = jnp.where(is_mix, resolved, rows)
    return rows


def resolve_rows(scene, rows, sampler):
    """Mix-resolve `rows` drawing from `sampler` — or, when the scene
    has no MIX rows, skip the gathers but still advance the sampler
    counter so every downstream RNG stream is unchanged."""
    if not scene.has_mix:
        sampler.skip(T.MAX_MIX_DEPTH)
        return rows
    u = [sampler.next1() for _ in range(T.MAX_MIX_DEPTH)]
    return resolve_mix(scene.materials, rows, u)


def surface_rgba(scene, rows, uv):
    """Per-ray surface color: texture sample when the row has one, else
    the row's solid albedo (reference: Surface::get_f, texture.rs:126-148).
    """
    materials = scene.materials
    m = _rows_of(materials, rows)
    solid = m[:, :4]                                     # (N,4) albedo
    if scene.atlas is None:
        return solid
    tex = _icol(m, T.MaterialTable.C_TEX)
    sampled = scene.atlas.sample(jnp.maximum(tex, 0), uv,
                                 raw=scene.mat_tex_raw)
    return jnp.where((tex >= 0)[:, None], sampled, solid)


def eve_surface(scene, rows, uv, hit=None):
    """EVE packed-PBR surface evaluation (reference: eve.rs:91-134).

    Returns (color (N,3), mix_ratio (N,), glow_emission (N,3)).
    `hit`: optional need mask — texel values are zeroed on lanes that
    did not hit textured geometry (every consumer already selects by
    is_eve).
    """
    materials = scene.materials
    m = _rows_of(materials, rows)
    tex = _icol(m, T.MaterialTable.C_TEX)
    tex_pmdg = _icol(m, T.MaterialTable.C_TEX_PMDG)
    ar = sample_tex(scene, tex, uv,
                    None if hit is None else (tex >= 0) & hit)
    pmdg = sample_tex(scene, tex_pmdg, uv,
                      None if hit is None else (tex_pmdg >= 0) & hit)
    albedo, roughness = ar[..., :3], ar[..., 3]
    paint = pmdg[..., 0]
    mat_mask = pmdg[..., 1]
    dirt = pmdg[..., 2]
    glow = pmdg[..., 3]

    # Faction palette lerp by mask * 3 (eve.rs:192-198).
    pal = m[:, T.MaterialTable.C_PALETTE].reshape(-1, 4, 3)   # (N,4,3)
    i = mat_mask * 3.0
    i0 = jnp.clip(jnp.floor(i).astype(jnp.int32), 0, 3)
    i1 = jnp.clip(jnp.ceil(i).astype(jnp.int32), 0, 3)
    frac = (i - i0.astype(jnp.float32))[..., None]
    # 4-way masked select instead of take_along_axis: four masked adds
    # are elementwise work that fuses.
    c0 = jnp.zeros(pal.shape[:1] + (3,), pal.dtype)
    c1 = jnp.zeros_like(c0)
    for k in range(4):
        c0 = c0 + pal[:, k] * (i0 == k)[:, None]
        c1 = c1 + pal[:, k] * (i1 == k)[:, None]
    mat_color = c0 * (1.0 - frac) + c1 * frac

    # Dirt-darkened, paint-blended albedo (eve.rs:103-108).
    dirt_c = jnp.minimum(dirt, 1.0)[..., None]
    color = ((albedo * mat_color * (1.0 - paint[..., None])
              + albedo * paint[..., None]) * (1.0 - dirt_c)
             + jnp.asarray([0.01, 0.005, 0.0]) * dirt[..., None])
    ratio = jnp.minimum(roughness + dirt, 1.0)
    glow_e = m[:, T.MaterialTable.C_GLOW] * glow[..., None] * 10.0
    return color, ratio, glow_e


def emitted(scene, hits, sampler):
    """Per-ray emission (reference: Hit::emit -> Material::emit).

    Mix rows re-roll their branch with a fresh draw, independent of the
    scatter draw, matching material.rs:410-416.  EVE rows emit their
    glow mask times the glow color times 10 (eve.rs:121-128).
    """
    materials = scene.materials
    rows = resolve_rows(scene, hits.material, sampler)
    m = _rows_of(materials, rows)
    mtype = _icol(m, T.MaterialTable.C_MTYPE)
    return _emitted_from(scene, rows, mtype, m[:, 6:9], hits)


def _emitted_from(scene, rows, mtype, emit_rgb, hits):
    is_light = mtype == T.DIFFUSE_LIGHT
    e = emit_rgb * is_light[:, None].astype(jnp.float32)
    if scene.atlas is not None:
        is_eve = mtype == T.EVE
        _, _, glow_e = eve_surface(scene, rows, hits.uv, hit=hits.hit)
        e = jnp.where(is_eve[:, None], glow_e, e)
    return jnp.where(hits.hit[:, None], e, 0.0)


def apply_normal_maps(scene, hits, d_in):
    """Tangent-space normal mapping (reference: geom.rs:554-561 +
    eve.rs:66-73,130-134).

    For EVE hits with a normal+occlusion texture and a valid tangent
    frame: decode the packed XY (green/alpha channels), reconstruct Z,
    combine in the hit's tangent frame using the pre-flip normal, then
    re-run set_face_normal — the reference's exact ordering
    (geom.rs:554-580).
    """
    materials = scene.materials
    rows = hits.material
    m = _rows_of(materials, rows)
    tex_no = _icol(m, T.MaterialTable.C_TEX_NO)
    has_frame = jnp.sum(hits.tangent * hits.tangent, axis=-1) > 0.0
    applies = ((_icol(m, T.MaterialTable.C_MTYPE) == T.EVE)
               & (tex_no >= 0) & hits.hit & has_frame)

    px = sample_tex(scene, tex_no, hits.uv, applies) * 2.0 - 1.0
    x = 1.0 - px[..., 1] ** 2 - px[..., 3] ** 2
    z = jnp.sqrt(jnp.abs(x))
    tn = vec.unit(jnp.stack([px[..., 1], px[..., 3], z], axis=-1))

    outward = hits.outward_normal
    mapped = (hits.tangent * tn[..., 0:1]
              + hits.bitangent * tn[..., 1:2]
              + outward * tn[..., 2:3])
    from ..geometry.hit import set_face_normal

    new_normal, new_ff = set_face_normal(d_in, mapped)
    return hits.replace(
        normal=jnp.where(applies[:, None], new_normal, hits.normal),
        front_face=jnp.where(applies, new_ff, hits.front_face))


def _schlick(cos_theta, refraction_ratio):
    """Schlick reflectance (reference: material.rs:296-299)."""
    r0 = ((1.0 - refraction_ratio) / (1.0 + refraction_ratio)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5


def scatter(scene, hits, d_in, sampler):
    """Batched Material::scatter over a wavefront.

    Args:
      scene: mrt.geometry.scene.Scene (for the material table + atlas).
      hits:  Hits record (front-faced normals already set).
      d_in:  (N,3) incoming ray directions (unnormalised).
      sampler: mrt.math.rng.Sampler for this bounce.

    Returns:
      (attenuation (N,3), new_direction (N,3), scattered (N,) bool,
      lobe (N,) int32).  Rays whose material absorbs (metal below
      horizon, lights, null) get scattered=False.  `lobe` classifies the
      chosen scatter distribution for NEE/MIS (materials/lights.py):
      0 = none/specular-like, 1 = cosine (Lambertian and the Lambertian
      arms of Specular/EVE), 2 = isotropic (volumes).
    """
    materials = scene.materials
    rows = resolve_rows(scene, hits.material, sampler)
    m = _rows_of(materials, rows)
    mtype = _icol(m, T.MaterialTable.C_MTYPE)
    return _scatter_from(scene, rows, mtype, m[:, :9], hits, d_in,
                         sampler)


def _scatter_from(scene, rows, mtype, params, hits, d_in, sampler):
    # scatter() body with the row resolution + packed-parameter gather
    # hoisted out (shared with shade_hit).
    normal = hits.normal

    # Shared random draws (each class consumes what it needs).
    u1, u2, u3, u_fresnel = sampler.next4()
    unit_sphere = sampling.in_unit_sphere(u1, u2, u3)        # (N,3)
    rand_unit = sampling.unit_vector(u1, u2)                 # (N,3)
    unit_d = vec.unit(d_in)

    solid_rgba = params[:, :4]
    if scene.atlas is None:
        rgba = solid_rgba
    else:
        tex = _icol(_rows_of(scene.materials, rows),
                    T.MaterialTable.C_TEX)
        # Same need expression as eve_surface's ar fetch -> the two
        # compact_apply calls CSE into one.
        sampled = sample_tex(scene, tex, hits.uv,
                             (tex >= 0) & hits.hit)
        rgba = jnp.where(((tex >= 0) & hits.hit)[:, None], sampled,
                         solid_rgba)
    albedo = rgba[..., :3]

    # --- Lambertian (material.rs:204-220) ---------------------------------
    lam_dir = normal + rand_unit
    lam_dir = jnp.where(vec.near_zero(lam_dir)[:, None], normal, lam_dir)

    # --- Metal (material.rs:261-284) --------------------------------------
    fuzz = params[:, 4]
    metal_dir = vec.reflect(unit_d, normal) + unit_sphere * fuzz[:, None]
    metal_ok = vec.dot(metal_dir, normal) > 0.0

    # --- Dielectric / Specular shared Fresnel (material.rs:302-329) -------
    ior = params[:, 5]
    refraction_ratio = jnp.where(hits.front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(vec.dot(-unit_d, normal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = refraction_ratio * sin_theta > 1.0
    reflect_choice = cannot_refract | (
        _schlick(cos_theta, refraction_ratio) > u_fresnel)
    refl_dir = vec.reflect(unit_d, normal)
    refr_dir = vec.refract(unit_d, normal, refraction_ratio)
    diel_dir = jnp.where(reflect_choice[:, None], refl_dir, refr_dir)

    # --- Specular: reflect w/ attenuation 1, else inner Lambertian --------
    spec_dir = jnp.where(reflect_choice[:, None], refl_dir, lam_dir)
    spec_atten = jnp.where(reflect_choice[:, None],
                           jnp.ones_like(albedo), albedo)

    # --- EVE packed-PBR: per-hit Mix(roughness+dirt, Lambertian(color),
    # Specular(1.8, color)) (eve.rs:100-118) -----------------------------
    is_eve = mtype == T.EVE
    one = jnp.ones_like(albedo)
    if scene.atlas is not None:
        eve_color, eve_ratio, _ = eve_surface(scene, rows, hits.uv,
                                              hit=hits.hit)
        u_eve = sampler.next1()
        pick_lam = u_eve < eve_ratio
        # Lambertian arm uses its own scatter direction; Specular arm is
        # the Fresnel gate computed above (ior 1.8 stored in the row).
        eve_dir = jnp.where(pick_lam[:, None], lam_dir, spec_dir)
        eve_atten = jnp.where(
            pick_lam[:, None], eve_color,
            jnp.where(reflect_choice[:, None], one, eve_color))
    else:
        eve_dir = normal
        eve_atten = one
        is_eve = jnp.zeros_like(is_eve)

    # --- Select by class --------------------------------------------------
    is_lam = mtype == T.LAMBERTIAN
    is_metal = mtype == T.METAL
    is_diel = mtype == T.DIELECTRIC
    is_iso = mtype == T.ISOTROPIC
    is_spec = mtype == T.SPECULAR

    sel = lambda m, x, y: jnp.where(m[:, None], x, y)
    new_dir = sel(is_lam, lam_dir,
                  sel(is_metal, metal_dir,
                      sel(is_diel, diel_dir,
                          sel(is_iso, unit_sphere,
                              sel(is_spec, spec_dir,
                                  sel(is_eve, eve_dir, normal))))))
    atten = sel(is_lam, albedo,
                sel(is_metal, albedo,
                    sel(is_diel, one,
                        sel(is_iso, albedo,
                            sel(is_spec, spec_atten,
                                sel(is_eve, eve_atten, one))))))

    scattered = hits.hit & (
        is_lam | is_diel | is_iso | is_spec | is_eve
        | (is_metal & metal_ok))

    # Scatter-lobe class for NEE/MIS: which rays took a cosine lobe
    # (NEE-capable) vs a specular-like or isotropic one.  The Specular
    # and EVE "diffuse" outcomes are exactly the cases where the chosen
    # direction was lam_dir.
    if scene.atlas is not None:
        eve_diffuse = is_eve & (pick_lam | ~reflect_choice)
    else:
        eve_diffuse = jnp.zeros_like(is_eve)
    cosine = is_lam | (is_spec & ~reflect_choice) | eve_diffuse
    lobe = jnp.where(cosine, 1, jnp.where(is_iso, 2, 0)).astype(jnp.int32)
    lobe = jnp.where(scattered, lobe, 0)
    return atten, new_dir, scattered, lobe


def shade_hit(scene, hits, d_in, em_sampler, sc_sampler):
    # Combined emission + scatter.  When the scene has no Mix rows the
    # material row resolution is the identity, so BOTH evaluations share
    # one mtype read and one packed-params read.  RNG streams are
    # identical to calling emitted() then scatter().
    materials = scene.materials
    if not scene.has_mix:
        em_sampler.skip(T.MAX_MIX_DEPTH)
        sc_sampler.skip(T.MAX_MIX_DEPTH)
        rows = hits.material
        params, mtype = materials.params[rows], materials.mtype[rows]
        e = _emitted_from(scene, rows, mtype, params[:, 6:9], hits)
        atten, new_dir, scattered, lobe = _scatter_from(
            scene, rows, mtype, params, hits, d_in, sc_sampler)
        return e, atten, new_dir, scattered, lobe
    e = emitted(scene, hits, em_sampler)
    atten, new_dir, scattered, lobe = scatter(scene, hits, d_in,
                                              sc_sampler)
    return e, atten, new_dir, scattered, lobe


def alpha_test(scene, rows, uv, sampler):
    """Material::alpha_test over a wavefront (material.rs:24-26,222-225).

    True = keep the hit.  Textured Lambertian/Metal/Specular rows test the
    sampled alpha != 0; everything else passes.  Mix re-rolls.
    """
    materials = scene.materials
    rows = resolve_rows(scene, rows, sampler)
    rgba = surface_rgba(scene, rows, uv)
    mtype = _icol(_rows_of(materials, rows), T.MaterialTable.C_MTYPE)
    tests_alpha = ((mtype == T.LAMBERTIAN) | (mtype == T.METAL)
                   | (mtype == T.SPECULAR))
    return ~tests_alpha | (rgba[..., 3] != 0.0)
