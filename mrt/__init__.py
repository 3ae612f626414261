"""mrt — a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``nickmass/mass-raytrace`` (a recursive, multi-threaded CPU ray tracer in
Rust).  Nothing here is a port: the recursive `Camera::trace`
(reference: world.rs:65-79) becomes a batched wavefront bounce loop
(`mrt.integrator.wavefront`), trait-object scenes become SoA arrays
(`mrt.geometry.scene`), `Box<dyn Material>` dispatch becomes masked
vectorised shading (`mrt.materials`), and `std::thread` row-stealing
becomes `shard_map` tile/sample sharding over a device mesh
(`mrt.parallel`).

Layout:
    mrt.math        vector math, counter-based RNG, closed-form sampling
    mrt.core        camera, rays, render configuration
    mrt.geometry    spheres, triangles, BVH, instances, volumes, scene SoA
    mrt.materials   material table + batched scatter/emit, backgrounds
    mrt.textures    texture atlas, bilinear sampling, wrap modes, combinators
    mrt.integrator  wavefront path-tracing integrator + AOV passes
    mrt.parallel    device-mesh sharding, collectives, distributed init
    mrt.loaders     OBJ/MTL, PLY, STL asset loaders
    mrt.scenes      the scene zoo (RTIOW, Cornell, SphereGrid, Menger, ...)
    mrt.runtime     accumulation, tonemap, PNG IO, checkpointing, config
"""

__version__ = "0.1.0"

import os as _os

# Fixed cache location inside the checkout: the path is part of what a
# later process looks up, so it must not depend on the process.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ):
    """Where JAX's persistent compilation cache goes, or None for off.

    `JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and is
    used as it is; otherwise `CACHE_DIR`.  Wavefront programs are large
    (bounce while_loop x ray batching), so caching them across
    processes cuts cold starts.  CPU runs (`JAX_PLATFORMS=cpu`, as the
    tests run) and `MRT_NO_COMPILE_CACHE=1` opt out.
    """
    if (environ.get("MRT_NO_COMPILE_CACHE")
            or environ.get("JAX_PLATFORMS", "").lower() == "cpu"):
        return None
    return environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


if compile_cache_dir(_os.environ) is not None:
    import jax as _jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
