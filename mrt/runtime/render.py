"""The render driver: progressive sample loop over jitted passes.

Replaces the reference's `render()` thread fan-out (reference:
src/main.rs:150-295): where the reference gives each CPU thread a private
whole-frame 1-spp pass and merges under a mutex, here one jitted program
renders a batch of spp and accumulation is pure addition on device.  The
multi-chip version in `mrt.parallel` shards the same pass over a mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..integrator import wavefront, aov
from .film import Film


@partial(jax.jit, static_argnames=("width", "height", "max_depth",
                                   "samples", "rr_depth"))
def render_pass(scene, camera, film: Film, seed, sample_start, *,
                width, height, max_depth=wavefront.MAX_DEPTH, samples=1,
                rr_depth=None):
    """Render `samples` 1-spp frames and merge into the film.

    The spp loop is a `lax.fori_loop` so any sample count compiles to one
    program; each iteration is an independent, schedule-invariant sample
    (decorrelated by sample index, like the reference's per-thread passes,
    main.rs:251-264).
    """
    def body(i, film):
        radiance, bounces = wavefront.render_sample(
            scene, camera, width, height, seed, sample_start + i,
            max_depth=max_depth, rr_depth=rr_depth)
        return film.merge(radiance, bounces)

    return jax.lax.fori_loop(0, samples, body, film)


@partial(jax.jit, static_argnames=("width", "height"))
def aov_pass(scene, camera, *, width, height, seed=0):
    """The albedo/normal guide pre-pass (reference: main.rs:167-222)."""
    return aov.albedo_normal_frame(scene, camera, width, height, seed=seed)


def render(scene, camera, width, height, spp=64, seed=1,
           max_depth=wavefront.MAX_DEPTH, samples_per_pass=None,
           with_aov=False, film=None, progress=None, persistent=False,
           rr_depth=None, sort_rays=None):
    """Progressive render to `spp` total samples.

    Args:
      samples_per_pass: spp chunk per device program (None = all at once).
      film: resume from an existing film (checkpointed state).
      progress: optional callback(film) after each pass.
      persistent: use the ray-regeneration integrator (fastest for deep
        max_depth; same estimator, different FP accumulation order).

    Returns the accumulated Film.
    """
    if film is None:
        film = Film.create(width, height)
    if with_aov:
        albedo, normal = aov_pass(scene, camera, width=width, height=height,
                                  seed=seed)
        film = film.with_aov(albedo, normal)

    pass_fn = render_pass_persistent if persistent else render_pass
    extra = {"sort_rays": sort_rays} if persistent else {}
    chunk = samples_per_pass or spp
    done = int(film.samples)
    while done < spp:
        step = min(chunk, spp - done)
        film = pass_fn(scene, camera, film, seed, done,
                       width=width, height=height, max_depth=max_depth,
                       samples=step, rr_depth=rr_depth, **extra)
        done += step
        if progress is not None:
            progress(film)
    return film


def render_pass_persistent(scene, camera, film: Film, seed, sample_start,
                           *, width, height,
                           max_depth=wavefront.MAX_DEPTH, samples=1,
                           pool=None, rr_depth=None, sort_rays=None):
    """Ray-regeneration render pass (integrator.persistent): ~100% lane
    utilisation regardless of depth — the fast path for deep bounces.

    sort_rays: lane-sort cadence in steps (0 or None = off)."""
    from ..integrator.persistent import render_samples_chunked, pool_for

    if pool is None:
        pool = pool_for(width * height, samples, max_depth)

    film_sum, depth_sum = render_samples_chunked(
        scene, camera, width, height, seed, sample_start, samples,
        max_depth=max_depth, pool=pool,
        film_sum=film.sum.reshape(-1, 3),
        depth_sum=film.depth_sum.reshape(-1), rr_depth=rr_depth,
        sort_rays=int(sort_rays or 0))
    return film.replace(
        sum=film_sum.reshape(height, width, 3),
        depth_sum=depth_sum.reshape(height, width),
        samples=film.samples + samples)
