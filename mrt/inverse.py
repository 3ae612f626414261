"""Inverse rendering: differentiate renders w.r.t. scene parameters.

The reference is forward-only; differentiability is a new
capability (SURVEY §7 step 7).  The integrator's `differentiable=True`
mode runs the bounce loop as a checkpointed scan so `jax.grad` flows
through hit geometry, attenuation, emission, textures and backgrounds;
discrete path decisions (hit selection, Fresnel/Mix branches, RNG) are
treated as detached — the standard reparameterised-path estimator.

Typical use: express the scene as a function of a parameter pytree,
render a small image, take gradients of a pixel loss, and optimise with
optax.  See `optimize` and tests/test_grad.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .integrator import wavefront
from .math.rng import Sampler


def render_image(scene, camera, width, height, spp=4, seed=0,
                 max_depth=6):
    """Differentiable mean-radiance image (H,W,3).

    Small-image, low-spp renders are the intended regime (the loss is a
    Monte Carlo estimate; fixed seed makes it deterministic so gradient
    steps don't chase sampler noise).
    """
    n = width * height
    ray_id = jnp.arange(n, dtype=jnp.uint32)
    px = (ray_id % jnp.uint32(width)).astype(jnp.float32)
    py = (ray_id // jnp.uint32(width)).astype(jnp.float32)

    acc = jnp.zeros((n, 3), jnp.float32)
    for s in range(spp):
        cam = Sampler(seed, ray_id + jnp.uint32(0x9E3779B9)
                      * jnp.uint32(s), salt=0xC0FFEE)
        jx, jy, du, dv = cam.next4()
        sx = (px + jx) / jnp.float32(width)
        ty = (py + jy) / jnp.float32(height)
        o, d = camera.rays(sx, ty, du, dv)
        salt = jnp.uint32(s) * jnp.uint32(0x85EBCA6B)
        radiance, _ = wavefront.trace_wavefront(
            scene, o, d, ray_id ^ salt, seed, max_depth=max_depth,
            differentiable=True)
        acc = acc + radiance
    return (acc / spp).reshape(height, width, 3)


def l2_loss(img, target):
    return jnp.mean((img - target) ** 2)


def make_loss(apply_fn, camera, width, height, target, spp=4, seed=0,
              max_depth=6):
    """Build loss(params): render apply_fn(params) and L2 against target.

    apply_fn: params pytree -> Scene.
    """
    def loss(params):
        scene = apply_fn(params)
        img = render_image(scene, camera, width, height, spp=spp,
                           seed=seed, max_depth=max_depth)
        return l2_loss(img, target)
    return loss


def optimize(apply_fn, init_params, camera, width, height, target, *,
             steps=100, learning_rate=0.05, spp=4, seed=0, max_depth=6,
             optimizer=None, callback=None):
    """Gradient-descend scene parameters to match a target image.

    Returns (params, losses).  Each step uses a different seed so the
    Monte Carlo gradient is unbiased across the trajectory.
    """
    import optax

    opt = optimizer or optax.adam(learning_rate)
    state = opt.init(init_params)
    params = init_params

    @jax.jit
    def step(params, state, step_seed):
        def seeded_loss(p):
            scene = apply_fn(p)
            img = render_image(scene, camera, width, height, spp=spp,
                               seed=step_seed, max_depth=max_depth)
            return l2_loss(img, target)

        value, grads = jax.value_and_grad(seeded_loss)(params)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, value

    losses = []
    for i in range(steps):
        params, state, value = step(params, state, seed + i)
        losses.append(float(value))
        if callback is not None:
            callback(i, params, float(value))
    return params, losses
