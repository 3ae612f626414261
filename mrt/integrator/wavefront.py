"""The wavefront path-tracing integrator.

This is the wavefront replacement of the reference's recursive
`Camera::trace` (reference: src/world.rs:65-79): instead of one call stack
per ray, a whole wavefront of N rays advances through a bounce loop
carrying SoA state — (origin, direction, throughput, radiance, alive).
Each bounce does a batched closest-hit query, batched emission + scatter
(masked by material class), and masked termination; `lax.fori_loop` with a
static trip count keeps everything statically shaped for XLA.

Termination semantics match the reference exactly:
  - depth exhausted      -> contributes black          (world.rs:66-67)
  - miss                 -> throughput * background    (world.rs:76-78)
  - absorbed (no scatter)-> emitted only               (world.rs:73-75)
  - scatter              -> emitted + atten * recurse  (world.rs:70-72)
which in wavefront form is
  radiance += throughput * emitted;  throughput *= atten.

Each ray also reports its bounce count, replacing the `(color, depth)`
return used for the Depth display mode (main.rs:655-666).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..math.rng import Sampler
from ..materials import shade

# Reference default (main.rs:37).
MAX_DEPTH = 50

T_MIN = 1e-3  # world.rs:68: intersect(ray, 0.001, inf)


def _bounce(scene, ray_id, seed, b, state, rr_depth=None):
    """One wavefront bounce: intersect, shade, terminate/continue.

    rr_depth: static; from that bounce on, paths survive Russian
    roulette with probability max(throughput) and are reweighted —
    an opt-in, unbiased way to kill deep low-energy paths early
    (beyond-reference; the reference runs every path to MAX_DEPTH).
    """
    o, d, throughput, radiance, alive, bounces, prev_pdf = state
    # Per-bounce samplers: every draw is a pure function of
    # (seed, ray_id, bounce), so results are schedule-invariant.
    vol_sampler = Sampler(seed, ray_id, salt=3 * b + 2)
    hits = scene.intersect(o, d, t_min=T_MIN, sampler=vol_sampler)

    em_sampler = Sampler(seed, ray_id, salt=3 * b)
    sc_sampler = Sampler(seed, ray_id, salt=3 * b + 1)

    emitted, atten, new_dir, scattered, lobe = shade.shade_hit(
        scene, hits, d, em_sampler, sc_sampler)

    background = scene.background_eval(d)

    live = alive
    hit = hits.hit & live
    miss = ~hits.hit & live

    if scene.lights is not None:
        # NEE+MIS (beyond-reference, opt-in): emission found by the
        # BSDF continuation of an NEE-capable vertex is weighted by the
        # power heuristic against the light-sampling pdf (prev_pdf = 0
        # means the previous vertex did no NEE -> full emission).
        from ..materials import table as T
        from ..materials import lights as lights_mod

        from ..materials.shade import _icol, _rows_of
        is_light = (_icol(_rows_of(scene.materials, hits.material),
                          T.MaterialTable.C_MTYPE) == T.DIFFUSE_LIGHT)
        w_b = lights_mod.mis_bsdf_weight(scene, hits, o, d, prev_pdf)
        emitted = emitted * jnp.where(is_light & (prev_pdf > 0.0),
                                      w_b, 1.0)[:, None]

    contrib = (jnp.where(miss[:, None], background, 0.0)
               + jnp.where(hit[:, None], emitted, 0.0))
    radiance = radiance + throughput * contrib

    next_pdf = jnp.zeros_like(prev_pdf)
    if scene.lights is not None:
        from ..materials import lights as lights_mod
        from ..math import vec

        # High-salt stream: never collides with the 3b+k bounce salts.
        nee_sampler = Sampler(seed, ray_id, salt=(1 << 30) + 3 * b)
        direct, did_nee = lights_mod.sample_direct(scene, hits,
                                                   nee_sampler,
                                                   lobe=lobe)
        did_nee = did_nee & hit
        radiance = radiance + jnp.where(
            did_nee[:, None], throughput * atten * direct, 0.0)
        # pdf of the chosen continuation under this vertex's lobe (the
        # other half of the MIS pair, consumed next bounce).
        next_pdf = lights_mod.bsdf_pdf(lobe, vec.unit(hits.normal),
                                       vec.unit(new_dir))

    cont = hit & scattered
    throughput = jnp.where(cont[:, None], throughput * atten, throughput)

    if rr_depth is not None:
        rr_sampler = Sampler(seed, ray_id, salt=(1 << 29) + b)
        p_survive = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0)
        roll = rr_sampler.next1() < p_survive
        apply_rr = cont & (b >= rr_depth)
        cont = cont & (~apply_rr | roll)
        throughput = jnp.where(apply_rr[:, None],
                               throughput / p_survive[:, None],
                               throughput)

    o = jnp.where(cont[:, None], hits.point, o)
    d = jnp.where(cont[:, None], new_dir, d)
    bounces = bounces + cont.astype(jnp.int32)
    return (o, d, throughput, radiance, cont, bounces,
            jnp.where(cont, next_pdf, 0.0))


def trace_wavefront(scene, o, d, ray_id, seed, max_depth=MAX_DEPTH,
                    differentiable=False, rr_depth=None, alive0=None):
    """Trace N rays to completion.

    Args:
      scene: geometry.scene.Scene.
      o, d: (N,3) ray origins / (unnormalised) directions.
      ray_id: (N,) int32 — stable per-ray stream ids for the RNG.
      seed: scalar uint32 render seed.
      max_depth: static bounce limit.
      differentiable: when True, run the bounce loop as a fixed-length
        `lax.scan` with per-bounce rematerialisation (`jax.checkpoint`)
        so `jax.grad` works through the whole path (SURVEY §7 step 7);
        gradients flow through hit geometry, attenuation, emission and
        backgrounds while discrete events (hit selection, Fresnel and
        Mix branches, RNG draws) are constant, like reparameterised
        detached sampling.  The default while_loop exits early once the
        wavefront dies, which reverse-mode AD cannot unroll.

    Returns:
      (radiance (N,3), bounces (N,) int32).
    """
    # Carry inits derive from the ray arrays so they inherit the rays'
    # varying-axes type under shard_map (fresh ones/zeros would not).
    # alive0 masks batch-pad lanes dead from bounce 0 so they never
    # extend the while_loop or waste leaf tests.
    init = (
        o, d,
        jnp.ones_like(o),
        jnp.zeros_like(o),
        (jnp.full_like(o[:, 0], True, dtype=bool)
         if alive0 is None else alive0),
        jnp.zeros_like(o[:, 0], dtype=jnp.int32),
        jnp.zeros_like(o[:, 0]),                     # prev_pdf (MIS)
    )

    if differentiable:
        @jax.checkpoint
        def scan_body(state, b):
            return _bounce(scene, ray_id, seed, b, state,
                           rr_depth=rr_depth), None

        state, _ = jax.lax.scan(scan_body, init,
                                jnp.arange(max_depth, dtype=jnp.int32))
        return state[3], state[5]

    def bounce(carry):
        b, state = carry
        return (b + 1, _bounce(scene, ray_id, seed, b, state,
                               rr_depth=rr_depth))

    def any_alive(carry):
        b, state = carry
        # Early exit once the whole wavefront is dead: in typical scenes
        # most paths terminate after a few bounces, so a while_loop makes
        # the cost track the *mean* path length instead of max_depth (the
        # reference's recursion gets this for free; a fori_loop wouldn't).
        return (b < max_depth) & jnp.any(state[4])

    _, (o, d, throughput, radiance, alive, bounces,
        _prev_nee) = jax.lax.while_loop(
        any_alive, bounce, (jnp.int32(0), init))
    # Rays still alive after max_depth bounces contribute black for the
    # remaining path — already the case since we never added their tail.
    return radiance, bounces


# Rays per device program: bounds the (sphere_chunk, BATCH) intersection
# temporaries in HBM; a 1080p frame runs as 16 sequential batches.
RAY_BATCH = 1 << 17


def trace_batched(scene, o, d, ray_id, seed, max_depth=MAX_DEPTH,
                  batch_size=RAY_BATCH, rr_depth=None):
    """trace_wavefront in fixed-size sequential batches via lax.map.

    Keeps peak memory flat for arbitrarily large frames; the pad lanes
    trace a throwaway +z ray.
    """
    n = o.shape[0]
    if n <= batch_size:
        return trace_wavefront(scene, o, d, ray_id, seed,
                               max_depth=max_depth, rr_depth=rr_depth)
    k = -(-n // batch_size)
    pad = k * batch_size - n

    def pad_to(x, value):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=value)

    o_b = pad_to(o, 0.0).reshape(k, batch_size, 3)
    d_b = pad_to(d, 1.0).reshape(k, batch_size, 3)  # avoid unit(0) NaNs
    id_b = pad_to(ray_id, 0).reshape(k, batch_size)
    alive_b = jnp.pad(jnp.ones((n,), bool), (0, pad),
                      constant_values=False).reshape(k, batch_size)

    def body(args):
        ob, db, ib, ab = args
        return trace_wavefront(scene, ob, db, ib, seed,
                               max_depth=max_depth, rr_depth=rr_depth,
                               alive0=ab)

    radiance, bounces = jax.lax.map(body, (o_b, d_b, id_b, alive_b))
    return (radiance.reshape(k * batch_size, 3)[:n],
            bounces.reshape(k * batch_size)[:n])


def render_sample(scene, camera, width, height, seed, sample_index,
                  max_depth=MAX_DEPTH, dtype=jnp.float32, rr_depth=None):
    """Render one 1-spp pass over the full frame (the unit of progressive
    accumulation, mirroring one reference render-thread pass,
    main.rs:256-264).

    Returns (radiance (H,W,3), bounces (H,W) int32).
    """
    n = width * height
    ray_id = jnp.arange(n, dtype=jnp.uint32)
    px = (ray_id % jnp.uint32(width)).astype(jnp.float32)
    py = (ray_id // jnp.uint32(width)).astype(jnp.float32)

    cam_sampler = Sampler(seed, ray_id + jnp.uint32(0x9E3779B9)
                          * jnp.uint32(sample_index), salt=0xC0FFEE)
    jx, jy, du, dv = cam_sampler.next4()

    # Pixel-jittered viewport coords; t runs bottom-up like the reference
    # (main.rs:258-259 uses y/height directly with a bottom-origin buffer).
    s = (px + jx) / jnp.float32(width)
    t = (py + jy) / jnp.float32(height)

    o, d = camera.rays(s, t, du, dv)
    sample_salt = jnp.uint32(sample_index) * jnp.uint32(0x85EBCA6B)
    radiance, bounces = trace_batched(
        scene, o, d, ray_id ^ sample_salt, seed, max_depth=max_depth,
        rr_depth=rr_depth)
    return (radiance.reshape(height, width, 3).astype(dtype),
            bounces.reshape(height, width))
