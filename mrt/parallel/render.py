"""Sharded progressive rendering over a (tile, spp) device mesh.

Replaces the reference's two thread fan-outs (row stealing + per-thread
sample passes, reference: src/main.rs:150-295) with one `shard_map`
program: every device renders its static row tile for its sample stride,
then the (radiance, bounce) sums are `psum`'d over the spp axis — the
only cross-device communication.  The film stays row-sharded
on device; nothing crosses hosts until export gathers it.

RNG discipline: random draws are pure functions of (seed, global pixel
id, global sample index), so a render is bit-identical for every mesh
shape (SURVEY §7 "hard parts" #5), up to float reassociation: the
order of float adds differs between mesh shapes in the psum and, on a
GPU, from run to run in the persistent film's atomic scatter-add.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..integrator import wavefront
from ..runtime.film import Film
from .mesh import TILE_AXIS, SPP_AXIS
from ..math.rng import Sampler


def _render_rows(scene, camera, width, height, row0, n_rows, seed,
                 sample_index, max_depth):
    """Trace one 1-spp pass for rows [row0, row0+n_rows)."""
    n = n_rows * width
    local = jnp.arange(n, dtype=jnp.uint32)
    ray_id = jnp.uint32(row0) * jnp.uint32(width) + local  # global pixel id
    px = (ray_id % jnp.uint32(width)).astype(jnp.float32)
    py = (ray_id // jnp.uint32(width)).astype(jnp.float32)

    cam_sampler = Sampler(seed, ray_id + jnp.uint32(0x9E3779B9)
                          * jnp.uint32(sample_index), salt=0xC0FFEE)
    jx, jy, du, dv = cam_sampler.next4()
    s = (px + jx) / jnp.float32(width)
    t = (py + jy) / jnp.float32(height)
    o, d = camera.rays(s, t, du, dv)
    sample_salt = jnp.uint32(sample_index) * jnp.uint32(0x85EBCA6B)
    radiance, bounces = wavefront.trace_wavefront(
        scene, o, d, ray_id ^ sample_salt, seed, max_depth=max_depth)
    return (radiance.reshape(n_rows, width, 3),
            bounces.reshape(n_rows, width))


def render_pass_sharded(scene, camera, film: Film, seed, sample_start, *,
                        width, height, samples, max_depth, mesh):
    """One jitted multi-device pass adding `samples` spp to the film.

    The film must be row-sharded over TILE_AXIS (use `shard_film`).
    `samples` must be a multiple of the spp-axis size.
    """
    n_tile = mesh.shape[TILE_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    if height % n_tile:
        raise ValueError(f"height {height} % tile axis {n_tile} != 0")
    if samples % n_spp:
        raise ValueError(f"samples {samples} % spp axis {n_spp} != 0")
    rows_per = height // n_tile
    my_samples = samples // n_spp

    def shard_fn(scene, camera, film_sum, film_depth, film_samples):
        tile = jax.lax.axis_index(TILE_AXIS)
        spp = jax.lax.axis_index(SPP_AXIS)
        row0 = tile * rows_per

        def body(i, acc):
            rad_acc, b_acc = acc
            sample_index = (sample_start
                            + (i * n_spp + spp))
            rad, bounces = _render_rows(
                scene, camera, width, height, row0, rows_per, seed,
                sample_index, max_depth)
            return rad_acc + rad, b_acc + bounces

        # zeros_like(film shard) inherits the tile-varying type; the body
        # additionally varies over the spp axis (sample indices are
        # strided by spp rank), so pcast the carry init to match.
        init = jax.lax.pcast(
            (jnp.zeros_like(film_sum), jnp.zeros_like(film_depth)),
            (SPP_AXIS,), to="varying")
        rad, bounces = jax.lax.fori_loop(0, my_samples, body, init)
        # psum over spp merges the sample strides (the reference's mutex
        # merge, main.rs:629-638) and restores spp-invariance.
        rad = jax.lax.psum(rad, SPP_AXIS)
        bounces = jax.lax.psum(bounces, SPP_AXIS)
        return (film_sum + rad, film_depth + bounces,
                film_samples + samples)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(TILE_AXIS, None, None), P(TILE_AXIS, None),
                  P()),
        out_specs=(P(TILE_AXIS, None, None), P(TILE_AXIS, None), P()),
    )
    new_sum, new_depth, new_samples = fn(
        scene, camera, film.sum, film.depth_sum, film.samples)
    return film.replace(sum=new_sum, depth_sum=new_depth,
                        samples=new_samples)


def shard_film(film: Film, mesh) -> Film:
    """Place the film row-sharded over the tile axis."""
    row_sharding = NamedSharding(mesh, P(TILE_AXIS, None, None))
    depth_sharding = NamedSharding(mesh, P(TILE_AXIS, None))
    rep = NamedSharding(mesh, P())
    return film.replace(
        sum=jax.device_put(film.sum, row_sharding),
        depth_sum=jax.device_put(film.depth_sum, depth_sharding),
        samples=jax.device_put(film.samples, rep),
    )


def render_sharded(scene, camera, width, height, mesh, spp=64, seed=1,
                   max_depth=wavefront.MAX_DEPTH, samples_per_pass=None,
                   film=None, persistent=False):
    """Progressive multi-device render (the multi-chip `runtime.render`).

    Returns the accumulated film (still row-sharded; arrays gather
    transparently on host access / export).
    """
    if film is None:
        film = Film.create(width, height)
    film = shard_film(film, mesh)

    pass_fn = (render_pass_sharded_persistent if persistent
               else render_pass_sharded)
    jitted = jax.jit(
        partial(pass_fn, width=width, height=height,
                max_depth=max_depth, mesh=mesh),
        static_argnames=("samples",))

    chunk = samples_per_pass or spp
    done = int(film.samples)
    while done < spp:
        step = min(chunk, spp - done)
        film = jitted(scene, camera, film, seed, done, samples=step)
        done += step
    return film


def render_pass_sharded_persistent(scene, camera, film: Film, seed,
                                   sample_start, *, width, height,
                                   samples, max_depth, mesh, pool=None):
    """Multi-device ray-regeneration pass: each device's lane pool
    consumes its own (row-tile x sample-stride) work queue; the only
    collective is one psum of the spp-axis contribution deltas."""
    from ..integrator.persistent import render_samples_persistent, pool_for

    n_tile = mesh.shape[TILE_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    if height % n_tile:
        raise ValueError(f"height {height} % tile axis {n_tile} != 0")
    if samples % n_spp:
        raise ValueError(f"samples {samples} % spp axis {n_spp} != 0")
    rows_per = height // n_tile
    my_samples = samples // n_spp
    pool = pool or pool_for(rows_per * width, my_samples, max_depth)

    def shard_fn(scene, camera, film_sum, film_depth, film_samples):
        tile = jax.lax.axis_index(TILE_AXIS)
        spp_r = jax.lax.axis_index(SPP_AXIS)
        fs_in = film_sum.reshape(-1, 3)
        ds_in = film_depth.reshape(-1)
        fs_out, ds_out = render_samples_persistent(
            scene, camera, width, height, seed,
            jnp.asarray(sample_start) + spp_r, my_samples,
            max_depth=max_depth, pool=pool,
            film_sum=fs_in, depth_sum=ds_in,
            pixel_offset=tile * rows_per * width,
            n_pixels=rows_per * width,
            sample_stride=n_spp)
        # Each spp rank added its own samples on top of the shared base;
        # psum the deltas so the base isn't multiplied.
        fs = fs_in + jax.lax.psum(fs_out - fs_in, SPP_AXIS)
        ds = ds_in + jax.lax.psum(ds_out - ds_in, SPP_AXIS)
        return (fs.reshape(rows_per, width, 3),
                ds.reshape(rows_per, width),
                film_samples + samples)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(TILE_AXIS, None, None), P(TILE_AXIS, None),
                  P()),
        out_specs=(P(TILE_AXIS, None, None), P(TILE_AXIS, None), P()),
    )
    new_sum, new_depth, new_samples = fn(
        scene, camera, film.sum, film.depth_sum, film.samples)
    return film.replace(sum=new_sum, depth_sum=new_depth,
                        samples=new_samples)
