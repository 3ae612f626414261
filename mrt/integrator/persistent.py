"""Persistent-wavefront integrator with ray regeneration.

The plain wavefront loop (`trace_wavefront`) keeps every lane occupied by
the same path until the whole batch dies, so at depth 50 with a mean
path length of ~3 most lanes idle ~94% of the iterations.  This module
is the wavefront analogue of persistent-threads path tracing: a fixed
pool of P lanes consumes a queue of (pixel, sample) work items; the
moment a path terminates its lane claims the next item and generates
that sample's camera ray.

Film accumulation: contributions go into a small rolling slot
accumulator `dest` (SLOTS pixels, a few MB) indexed by pixel % SLOTS
rather than into the full-frame film, so the per-step scatter-add has a
small destination.  Work items are claimed PIXEL-MAJOR so in-flight
pixels span a narrow moving window, claims are gated to pixels <
flushed + SLOTS, and once a slab of SLOTS/SLABS pixels is fully claimed
and passed by every live path it is flushed into the big film with one
contiguous dynamic-slice add (no scatter) and zeroed for reuse.  The
window must out-span the deepest path: claims advance at
~pool/avg_depth items/step while a depth-50 straggler pins the flush
frontier for 50 steps, so SLOTS*spp must exceed ~50*pool/avg_depth
items — the driver shrinks the POOL at low spp to keep this true.  When
the whole film fits in SLOTS (tests, sharded tiles) the accumulator IS
the film slice and nothing gates or flushes until the end.

Equivalence: every random draw is the same pure function of
(seed, pixel, sample, bounce) as the batched integrator, so this
produces the same estimator with the same streams — only the float
accumulation order differs (tested to ~1e-5 of the batch path).  On a
GPU the scatter-add uses atomics, so that order also changes from run
to run.

Two drivers share the step function:
  - `render_samples_persistent`: one device-side while_loop — used
    inside jit/shard_map programs (the multi-device path).
  - `render_samples_chunked`: Python-level loop over bounded-length
    dispatches — the single-device default.  A dispatch never runs more
    than `chunk_steps` wavefront steps, so the host can observe
    progress between chunks.

The reference's analogue is its thread pool re-rendering whole frames
per pass (reference: src/main.rs:234-294); regeneration here plays the
role of the OS scheduler keeping CPU cores busy.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

from ..math.rng import Sampler
from ..materials import shade
from .wavefront import MAX_DEPTH, T_MIN

POOL = 1 << 17
CHUNK_STEPS = 8
# Rolling film-slot accumulator (pixels): the claim window.  It must
# cover claim_rate * max_path_depth items or the deepest path stalls the
# flush frontier and starves claims; with SLOTS fixed, that constraint
# is met by shrinking the POOL instead (render.render_pass_persistent).
SLOTS = 1 << 18
SLABS = 8          # slabs per window: flush granularity (slots//SLABS)
FLUSH_STEPS = 8

_BIG = jnp.int32(2 ** 30)


def _slots_for(npix, slots):
    """Static layout: (slots_eff, slab, npix_pad, big_mode)."""
    slots = min(slots, SLOTS) if slots else SLOTS
    if npix <= slots:
        # Small mode: the accumulator IS the (padded) film slice.
        pad = -npix % 8
        return npix + pad, npix + pad, npix + pad, False
    # Big-mode slot indexing is `q & (slots-1)`: power of two required.
    assert slots & (slots - 1) == 0, f"slots {slots} not a power of 2"
    slab = max(slots // SLABS, 8)
    npix_pad = -(-npix // slab) * slab
    return slots, slab, npix_pad, True


def pool_for(npix, samples, max_depth, pool=POOL):
    """Lane-pool size for a pass over `npix` pixels.

    Big-frame claim-window safety: the rolling slot window holds
    SLOTS*samples items; claims advance ~pool/avg_depth items per step
    and a straggler pins the flush frontier for up to max_depth +
    flush-lag steps.  Cap the pool so the window out-spans the deepest
    path (~2x margin at avg_depth ~2.5; an uncapped pool of 2^17 behind
    a 2M-item window starves to a few per cent of lanes active)."""
    if npix > SLOTS:
        cap = int(SLOTS * samples * 2.0 / (max_depth + FLUSH_STEPS))
        pool = max(8192, min(pool, cap // 8192 * 8192))
    return pool


def _morton3(x, y, z):
    """Interleave three 6-bit uint32 coordinates into an 18-bit Morton
    code (unrolled shifts: 6 iterations on the whole lane vector)."""
    out = jnp.zeros_like(x)
    for b in range(6):
        out = (out
               | (((x >> b) & 1) << (3 * b))
               | (((y >> b) & 1) << (3 * b + 1))
               | (((z >> b) & 1) << (3 * b + 2)))
    return out


def _make_sorter(scene, total):
    """Lane permutation by ray-coherence key: Morton cell of the origin
    (6 bits/axis over the scene bounds, high bits) + Morton cell of the
    direction (4 bits/axis, low bits).  After a few bounces neighbouring
    lanes diverge, so groups of lanes that traverse together pay the
    union of their rays' subtrees; sorting regroups them spatially.  The
    direction bits matter most for freshly regenerated camera rays: a
    pinhole camera puts EVERY primary ray in the same origin cell, so
    without them bounce-0 lanes stay in scanline order.
    Semantically free: every per-lane quantity rides the same
    permutation, the RNG is keyed on (ray_id, bounce), and film
    scatters index by work item.  Idle lanes sort to the end.

    Origin bounds: static scene bounds degenerate on scenes whose
    emissive set dwarfs the detailed geometry — lucy's sun sphere at
    (10000,4000,4800) r1500 makes a 64-cell grid ~195 units/cell, so
    the whole 33-unit statue field quantises to ONE cell and the key
    collapses to direction bits.  MRT_SORT_DYN=1 instead quantises
    over the ACTIVE wavefront's own per-sort origin bounds (two masked
    reductions; emissive hits terminate, so live origins concentrate
    on the detailed geometry).  Permutation-only either way — the film
    is bit-identical; only lane coherence changes."""
    dynamic = os.environ.get("MRT_SORT_DYN", "0") == "1"
    bmin, bmax = scene.world_bounds()
    inv_ext = 63.0 / jnp.maximum(bmax - bmin, 1e-6)

    def sort_lanes(state):
        (item, bounce, o, d, throughput, ray_id, next_work,
         dest, flushed_q, prev_pdf) = state
        active = item < total
        # Direction cell: 4 bits/axis on the (unnormalised-safe)
        # component signs+magnitudes; interleaved -> 12 bits.
        dn = d * jax.lax.rsqrt(jnp.maximum(
            jnp.sum(d * d, axis=-1, keepdims=True), 1e-20))
        dcell = jnp.clip((dn + 1.0) * 8.0, 0.0, 15.0).astype(jnp.uint32)
        dkey = _morton3(dcell[:, 0], dcell[:, 1], dcell[:, 2])
        if dynamic:
            big = jnp.float32(3.4e38)
            act3 = active[:, None]
            lo = jnp.min(jnp.where(act3, o, big), axis=0)
            hi = jnp.max(jnp.where(act3, o, -big), axis=0)
            inv = 63.0 / jnp.maximum(hi - lo, 1e-6)
            cell = jnp.clip((o - lo) * inv, 0.0, 63.0).astype(jnp.uint32)
        else:
            cell = jnp.clip((o - bmin) * inv_ext, 0.0,
                            63.0).astype(jnp.uint32)
        key = (_morton3(cell[:, 0], cell[:, 1], cell[:, 2]) << 12) | dkey
        key = jnp.where(active, key, jnp.uint32(0xFFFFFFFF))
        perm = jnp.argsort(key)
        g = lambda a: jnp.take(a, perm, axis=0)
        return (g(item), g(bounce), g(o), g(d), g(throughput), g(ray_id),
                next_work, dest, flushed_q, g(prev_pdf))

    return sort_lanes



def _flush_block(step, sorter, cadence):
    """One FLUSH_STEPS block of wavefront steps with lane sorting every
    `cadence` steps.  Cadence matters: ~1/3 of lanes die and re-claim
    EVERY step, landing at scattered lane positions, so a sort only
    every FLUSH_STEPS leaves most lanes scrambled most of the time."""
    if sorter is None:
        return lambda st: jax.lax.fori_loop(
            0, FLUSH_STEPS, lambda i, s: step(s), st)
    cadence = max(1, min(int(cadence), FLUSH_STEPS))
    n_blk = FLUSH_STEPS // cadence

    def blk(st):
        def one(i, s):
            s = jax.lax.fori_loop(0, cadence, lambda k, x: step(x), s)
            return sorter(s)
        return jax.lax.fori_loop(0, n_blk, one, st)

    return blk


def _build(scene, camera, width, height, seed, sample_start, samples,
           max_depth, pool, pixel_offset, n_pixels, sample_stride,
           rr_depth, slots=None):
    """Returns (total, make_rays, step, layout) for the wavefront.

    Work items are PIXEL-MAJOR: item -> (pixel = item // samples,
    sample = item % samples), so claims sweep the frame front-to-back
    and in-flight pixels stay within a rolling window (the slot
    accumulator's reuse-safety precondition).
    """
    npix = n_pixels if n_pixels is not None else width * height
    total = npix * samples  # `samples` may be traced: total only feeds
    # comparisons/arithmetic, never shapes — one compile serves any spp.
    layout = _slots_for(npix, slots)
    slots_eff, slab, npix_pad, big_mode = layout

    inv_w = 1.0 / jnp.float32(width)
    inv_h = 1.0 / jnp.float32(height)

    # Idle lanes are parked on a NEUTRAL ray that starts past the scene
    # on every axis and points away, so the acceleration root's slab
    # test rejects it immediately.  Without this, a lane that dies with
    # no work left keeps re-traversing its stale ray every step; on
    # Menger L5 (depth 8, pool >= queue) most of the traversal would be
    # stale.  Semantically free: every film contribution is `active`-gated.
    _bmin, _bmax = scene.world_bounds()
    neutral_o = _bmax + jnp.maximum(_bmax - _bmin, 1.0)
    neutral_d = jnp.full((3,), 0.57735027, jnp.float32)

    def make_rays(item):
        """Camera rays for work items, with the exact RNG stream of
        wavefront.render_sample."""
        q = item // samples
        s_idx = item - q * samples
        pixel = jnp.uint32(pixel_offset) + q.astype(jnp.uint32)
        sample = (jnp.uint32(sample_start)
                  + s_idx.astype(jnp.uint32) * jnp.uint32(sample_stride))
        px = (pixel % jnp.uint32(width)).astype(jnp.float32)
        py = (pixel // jnp.uint32(width)).astype(jnp.float32)
        cam = Sampler(seed, pixel + jnp.uint32(0x9E3779B9) * sample,
                      salt=0xC0FFEE)
        jx, jy, du, dv = cam.next4()
        s = (px + jx) * inv_w
        t = (py + jy) * inv_h
        o, d = camera.rays(s, t, du, dv)
        ray_id = pixel ^ (sample * jnp.uint32(0x85EBCA6B))
        return o, d, ray_id

    def step(state):
        (item, bounce, o, d, throughput, ray_id, next_work,
         dest, flushed_q, prev_pdf) = state
        active = item < total
        q = jnp.clip(item, 0, total - 1) // samples  # local pixel index

        b = bounce
        vol_sampler = Sampler(seed, ray_id, salt=3 * b + 2)
        hits = scene.intersect(o, d, t_min=T_MIN, sampler=vol_sampler)
        em_sampler = Sampler(seed, ray_id, salt=3 * b)
        sc_sampler = Sampler(seed, ray_id, salt=3 * b + 1)
        emitted, atten, new_dir, scattered, lobe = shade.shade_hit(
            scene, hits, d, em_sampler, sc_sampler)

        hit = hits.hit & active
        miss = ~hits.hit & active
        # Pre-masked background: zeros on non-miss lanes.
        background = scene.background_eval_masked(d, miss)

        if scene.lights is not None:
            # NEE+MIS emission weighting (see wavefront._bounce).
            from ..materials import table as T
            from ..materials import lights as lights_mod

            from ..materials.shade import _icol, _rows_of
            is_light = (_icol(_rows_of(scene.materials, hits.material),
                              T.MaterialTable.C_MTYPE)
                        == T.DIFFUSE_LIGHT)
            w_b = lights_mod.mis_bsdf_weight(scene, hits, o, d,
                                             prev_pdf)
            emitted = emitted * jnp.where(is_light & (prev_pdf > 0.0),
                                          w_b, 1.0)[:, None]

        radiance_add = (background
                        + jnp.where(hit[:, None], emitted, 0.0))
        radiance_add = jnp.where(active[:, None],
                                 throughput * radiance_add, 0.0)

        next_pdf = jnp.zeros_like(prev_pdf)
        if scene.lights is not None:
            from ..materials import lights as lights_mod
            from ..math import vec

            nee_sampler = Sampler(seed, ray_id, salt=(1 << 30) + 3 * b)
            direct, did_nee = lights_mod.sample_direct(scene, hits,
                                                       nee_sampler,
                                                       lobe=lobe)
            did_nee = did_nee & hit
            radiance_add = radiance_add + jnp.where(
                did_nee[:, None], throughput * atten * direct, 0.0)
            next_pdf = lights_mod.bsdf_pdf(lobe, vec.unit(hits.normal),
                                           vec.unit(new_dir))

        scat = hit & scattered
        cont = scat & (b + 1 < max_depth)

        if rr_depth is not None:
            # Russian roulette (see wavefront._bounce).  Applied to
            # `scat` (not the depth-gated cont) so the bounce counts
            # match the batched integrator exactly.
            rr_sampler = Sampler(seed, ray_id, salt=(1 << 29) + b)
            tp_next = throughput * atten
            p_survive = jnp.clip(jnp.max(tp_next, axis=-1), 0.05, 1.0)
            roll = rr_sampler.next1() < p_survive
            apply_rr = scat & (b >= rr_depth)
            scat = scat & (~apply_rr | roll)
            cont = cont & scat
            atten = jnp.where(apply_rr[:, None],
                              atten / p_survive[:, None], atten)

        # Film contribution: radiance (3) + depth count (1) — into the
        # SMALL slot accumulator, never the full film (the in-loop
        # scatter cost scales with the carried destination size).
        slot = q & jnp.int32(slots_eff - 1) if big_mode else q
        contrib = jnp.concatenate(
            [radiance_add, scat.astype(jnp.float32)[:, None]], axis=-1)
        if os.environ.get("MRT_NAN_GUARD") == "1":
            # Opt-in film guard: drop non-finite contributions so one
            # degenerate path cannot poison a pixel's accumulation for
            # the rest of a showcase render.
            contrib = jnp.where(jnp.isfinite(contrib), contrib, 0.0)
        dest = dest.at[slot].add(contrib)

        # Regenerate dead lanes from the queue, gated so no claimed
        # pixel runs SLOTS ahead of the flush frontier (slot-reuse
        # safety; a gated lane idles and re-claims next step).
        dead = active & ~cont
        idle = ~active
        claim = dead | idle
        offsets = jnp.cumsum(claim.astype(jnp.int32)) - 1
        new_item = next_work + offsets
        if big_mode:
            limit = jnp.minimum(total, (flushed_q + slots_eff) * samples)
        else:
            limit = total
        takes = claim & (new_item < limit)
        # takes is a prefix of claims (offsets increase), so advancing
        # by its count skips no items.
        next_work = next_work + jnp.sum(takes.astype(jnp.int32))

        item = jnp.where(cont, item,
                         jnp.where(takes, new_item, total))
        no, nd, nrid = make_rays(jnp.where(takes, new_item, 0))

        o = jnp.where(cont[:, None], hits.point,
                      jnp.where(takes[:, None], no, neutral_o))
        d = jnp.where(cont[:, None], new_dir,
                      jnp.where(takes[:, None], nd, neutral_d))
        throughput = jnp.where(
            cont[:, None], throughput * atten,
            jnp.where(takes[:, None], jnp.ones_like(throughput),
                      throughput))
        ray_id = jnp.where(cont, ray_id, jnp.where(takes, nrid, ray_id))
        bounce = jnp.where(cont, b + 1, 0)
        prev_pdf = jnp.where(cont, next_pdf, 0.0)

        return (item, bounce, o, d, throughput, ray_id, next_work,
                dest, flushed_q, prev_pdf)

    def maybe_flush(state, film):
        """Flush the next slab [flushed_q, flushed_q+slab) of `dest`
        into `film` when it is fully claimed (or the queue is done) and
        every live path has moved past it.  One contiguous
        dynamic-slice add — no scatter touches the big film."""
        if not big_mode:
            return state, film
        item, next_work, dest, flushed_q = (state[0], state[6],
                                            state[7], state[8])
        active = item < total
        q = jnp.clip(item, 0, total - 1) // samples
        min_live = jnp.min(jnp.where(active, q, _BIG))
        claimed_q = next_work // samples
        ready = (claimed_q >= flushed_q + slab) | (next_work >= total)
        clear = min_live >= flushed_q + slab
        can = ready & clear & (flushed_q < jnp.int32(npix))

        def do(args):
            film, dest = args
            s_idx = flushed_q & jnp.int32(slots_eff - 1)
            chunk = jax.lax.dynamic_slice(dest, (s_idx, 0), (slab, 4))
            cur = jax.lax.dynamic_slice(film, (flushed_q, 0), (slab, 4))
            film = jax.lax.dynamic_update_slice(film, cur + chunk,
                                                (flushed_q, 0))
            dest = jax.lax.dynamic_update_slice(
                dest, jnp.zeros((slab, 4), jnp.float32), (s_idx, 0))
            return film, dest

        film, dest = jax.lax.cond(can, do, lambda a: a, (film, dest))
        flushed_q = jnp.where(can, flushed_q + slab, flushed_q)
        return state[:7] + (dest, flushed_q, state[9]), film

    def finalize(state, film):
        """Drain every remaining slab (the unflushed window is at most
        SLABS slabs wide, +1 for a partial tail)."""
        if not big_mode:
            return film + state[7]
        for _ in range(slots_eff // slab + 2):
            state, film = maybe_flush(state, film)
        return film

    return (total, make_rays, step, maybe_flush, finalize, layout,
            (neutral_o, neutral_d))


def _init_state(make_rays, pool, dest, vzero_f, vzero_i, init_limit,
                neutral=None):
    """Initial claims honor the same slot-window gate as in-loop claims
    (`init_limit` = slots_eff*samples in big mode): lanes past the gate
    start idle and claim once flushing opens the window."""
    lane = jnp.arange(pool, dtype=jnp.int32) + vzero_i
    take = lane < init_limit
    init_item = jnp.where(take, lane, _BIG)
    o0, d0, rid0 = make_rays(jnp.where(take, lane, 0))
    if neutral is not None:
        o0 = jnp.where(take[:, None], o0, neutral[0])
        d0 = jnp.where(take[:, None], d0, neutral[1])
    state = (
        init_item,                                   # work item
        jnp.zeros((pool,), jnp.int32) + vzero_i,     # bounce
        o0, d0,
        jnp.ones_like(o0),                           # throughput
        rid0,
        jnp.minimum(jnp.int32(pool),                 # next_work
                    init_limit) + vzero_i,
        dest + vzero_f,                              # slot accumulator
        jnp.int32(0) + vzero_i,                      # flushed_q
        jnp.zeros((pool,), jnp.float32) + vzero_f,   # prev_pdf (MIS)
    )
    return state


def _pack_film(film_sum, depth_sum, npix_pad):
    packed = jnp.concatenate(
        [film_sum, depth_sum.astype(jnp.float32)[:, None]], axis=-1)
    pad = npix_pad - packed.shape[0]
    if pad:
        packed = jnp.pad(packed, ((0, pad), (0, 0)))
    return packed


def _unpack_film(film, npix):
    film = film[:npix]
    return film[:, :3], jnp.round(film[:, 3]).astype(jnp.int32)


def render_samples_persistent(scene, camera, width, height, seed,
                              sample_start, samples,
                              max_depth=MAX_DEPTH, pool=POOL,
                              film_sum=None, depth_sum=None,
                              pixel_offset=0, n_pixels=None,
                              sample_stride=1, rr_depth=None,
                              slots=None, sort_rays=False):
    """Single device-side while_loop (for use inside jit/shard_map).

    Returns (film_sum (n_pixels,3), depth_sum (n_pixels,)) — pass them
    back in to accumulate further passes.
    """
    npix = n_pixels if n_pixels is not None else width * height
    if film_sum is None:
        film_sum = jnp.zeros((npix, 3), jnp.float32)
    if depth_sum is None:
        depth_sum = jnp.zeros((npix,), jnp.int32)

    # Varying-axes seed: loop-carry inits must inherit the varying type
    # of the shard inputs under shard_map (no-op zeros otherwise).
    vzero_f = (film_sum.ravel()[0] * 0.0
               + jnp.asarray(sample_start, jnp.float32) * 0.0)
    vzero_i = vzero_f.astype(jnp.int32)

    (total, make_rays, step, maybe_flush, finalize, layout,
     neutral) = _build(
        scene, camera, width, height, seed, sample_start, samples,
        max_depth, pool, pixel_offset, n_pixels, sample_stride, rr_depth,
        slots)
    slots_eff, slab, npix_pad, big_mode = layout

    film = _pack_film(film_sum, depth_sum, npix_pad) + vzero_f
    if big_mode:
        dest = jnp.zeros((slots_eff, 4), jnp.float32)
        work_film = film
        init_limit = jnp.int32(slots_eff) * jnp.asarray(samples, jnp.int32)
    else:
        dest = jnp.zeros((npix_pad, 4), jnp.float32)
        work_film = film  # untouched until the final add
        init_limit = _BIG
    state = _init_state(make_rays, pool, dest, vzero_f, vzero_i,
                        init_limit, neutral)

    def cond(carry):
        state, film = carry
        return jnp.any(state[0] < total) | (state[6] < total)

    sorter = _make_sorter(scene, total) if sort_rays else None
    run_block = _flush_block(step, sorter,
                             int(sort_rays) or FLUSH_STEPS)

    def body(carry):
        state, film = carry
        state = run_block(state)
        state, film = maybe_flush(state, film)
        state, film = maybe_flush(state, film)
        return state, film

    state, film = jax.lax.while_loop(cond, body, (state, work_film))
    film = finalize(state, film)
    return _unpack_film(film, npix)


@partial(jax.jit, static_argnames=("width", "height", "max_depth",
                                   "pool", "rr_depth", "slots",
                                   "sort_rays"))
def _chunk_init(scene, camera, film_sum, depth_sum, seed, sample_start,
                samples, *, width, height, max_depth, pool, rr_depth,
                slots=None, sort_rays=False):
    (total, make_rays, step, maybe_flush, finalize, layout,
     neutral) = _build(
        scene, camera, width, height, seed, sample_start, samples,
        max_depth, pool, 0, None, 1, rr_depth, slots)
    slots_eff, slab, npix_pad, big_mode = layout
    zero = jnp.float32(0.0)
    dest = jnp.zeros((slots_eff if big_mode else npix_pad, 4),
                     jnp.float32)
    film = _pack_film(film_sum, depth_sum, npix_pad)
    init_limit = (jnp.int32(slots_eff) * jnp.asarray(samples, jnp.int32)
                  if big_mode else _BIG)
    return (_init_state(make_rays, pool, dest, zero, jnp.int32(0),
                        init_limit, neutral), film)


@partial(jax.jit, static_argnames=("width", "height", "max_depth",
                                   "pool", "rr_depth", "slots",
                                   "sort_rays"))
def _chunk_run(scene, camera, state, film, seed, sample_start, samples,
               chunk_steps, *, width, height, max_depth, pool, rr_depth,
               slots=None, sort_rays=False):
    # chunk_steps is TRACED: the adaptive driver changes it per chunk
    # without recompiling.
    (total, _, step, maybe_flush, finalize, layout, neutral) = _build(
        scene, camera, width, height, seed, sample_start, samples,
        max_depth, pool, 0, None, 1, rr_depth, slots)
    sorter = _make_sorter(scene, total) if sort_rays else None
    run_block = _flush_block(step, sorter,
                             int(sort_rays) or FLUSH_STEPS)

    def cond(carry):
        i, st, film = carry
        return ((i < chunk_steps)
                & (jnp.any(st[0] < total) | (st[6] < total)))

    def body(carry):
        i, st, film = carry
        st = run_block(st)
        st, film = maybe_flush(st, film)
        st, film = maybe_flush(st, film)
        return i + FLUSH_STEPS, st, film

    _, state, film = jax.lax.while_loop(cond, body,
                                        (jnp.int32(0), state, film))
    more = jnp.any(state[0] < total) | (state[6] < total)
    return state, film, more


@partial(jax.jit, static_argnames=("width", "height", "max_depth",
                                   "pool", "rr_depth", "slots",
                                   "sort_rays"))
def _chunk_finalize(scene, camera, state, film, seed, sample_start,
                    samples, *, width, height, max_depth, pool,
                    rr_depth, slots=None, sort_rays=False):
    total, _, _, _, finalize, layout, _n = _build(
        scene, camera, width, height, seed, sample_start, samples,
        max_depth, pool, 0, None, 1, rr_depth, slots)
    npix = width * height
    film = finalize(state, film)
    return _unpack_film(film, npix)


# Adaptive chunking: target seconds of device time per dispatch — long
# enough to amortise the host round-trip between dispatches.
CHUNK_TARGET_SECONDS = 10.0
CHUNK_MAX_STEPS = 4096


def render_samples_chunked(scene, camera, width, height, seed,
                           sample_start, samples, max_depth=MAX_DEPTH,
                           pool=POOL, film_sum=None, depth_sum=None,
                           rr_depth=None, chunk_steps=CHUNK_STEPS,
                           slots=None, sort_rays=False):
    """Python-driven chunked dispatches (single-chip fast path).

    Identical results to `render_samples_persistent`; each dispatch is
    bounded in wavefront steps, and the bound adapts to the measured
    step rate so dispatches stay near CHUNK_TARGET_SECONDS.
    """
    import time

    npix = width * height
    if film_sum is None:
        film_sum = jnp.zeros((npix, 3), jnp.float32)
    if depth_sum is None:
        depth_sum = jnp.zeros((npix,), jnp.int32)

    statics = dict(width=width, height=height, max_depth=max_depth,
                   pool=pool, rr_depth=rr_depth, slots=slots,
                   sort_rays=sort_rays)
    state, film = _chunk_init(scene, camera, film_sum, depth_sum, seed,
                              sample_start, samples, **statics)
    steps = max(chunk_steps, FLUSH_STEPS)
    while True:
        t0 = time.perf_counter()
        state, film, more = _chunk_run(scene, camera, state, film, seed,
                                       sample_start, samples,
                                       jnp.int32(steps), **statics)
        more = bool(more)  # device sync: chunk has finished
        dt = time.perf_counter() - t0
        if not more:
            break
        per_step = max(dt / steps, 1e-4)
        steps = int(min(max(CHUNK_TARGET_SECONDS / per_step, CHUNK_STEPS),
                        CHUNK_MAX_STEPS))
    return _chunk_finalize(scene, camera, state, film, seed,
                           sample_start, samples, **statics)
