"""Batched 3-vector math on arrays of shape (..., 3).

The reference implements V3 as a scalar struct with operator overloads
(reference: src/math.rs:47-149, src/math/generic.rs).  For batched JAX
code the natural representation is an array whose trailing axis is the component axis, so a
"V3" here is any ``(..., 3)`` array and every op below is batched.  All
helpers are pure jnp and differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp

# Matches the reference's near-zero epsilon (src/math.rs:111-113).
NEAR_ZERO_EPS = 1e-5


def v3(x, y, z):
    """Build a (..., 3) vector from components (broadcasting)."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(z, jnp.float32)), axis=-1)


def dot(a, b):
    """Component dot product over the trailing axis -> (...)."""
    return jnp.sum(a * b, axis=-1)


def length_squared(a):
    return dot(a, a)


def length(a):
    return jnp.sqrt(length_squared(a))


def unit(a):
    """a / |a| (reference: math.rs:76-78). No epsilon: matches reference."""
    return a / length(a)[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1)


def near_zero(a):
    """All components within eps of zero (reference: math.rs:111-113)."""
    return jnp.all(jnp.abs(a) <= NEAR_ZERO_EPS, axis=-1)


def reflect(v, n):
    """Mirror reflect v about normal n (reference: math.rs:115-117)."""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(uv, n, etai_over_etat):
    """Snell refraction of *unit* vector uv (reference: math.rs:119-124).

    ``etai_over_etat`` broadcasts as (...)-shaped.  The sqrt uses the
    where-before-sqrt pattern: shading evaluates the refraction branch
    masked for every ray, and sqrt'(0)=inf at grazing lanes would turn
    the masked-out backward pass into NaN (0 * inf).
    """
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = (uv + n * cos_theta[..., None]) * etai_over_etat[..., None]
    k = jnp.abs(1.0 - length_squared(r_out_perp))
    safe = jnp.sqrt(jnp.where(k > 0.0, k, 1.0))
    r_out_parallel = n * -jnp.where(k > 0.0, safe, 0.0)[..., None]
    return r_out_perp + r_out_parallel


def distance(a, b):
    return length(a - b)


def hsl_to_rgb(hsl):
    """HSL -> RGB, h/s/l all in [0,1] (reference: math.rs:126-143).

    Branch-free reformulation of the reference's 6-way match.
    """
    h = jnp.clip(hsl[..., 0], 0.0, 1.0) * 360.0
    s = jnp.clip(hsl[..., 1], 0.0, 1.0)
    l = jnp.clip(hsl[..., 2], 0.0, 1.0)

    c = (1.0 - jnp.abs(2.0 * l - 1.0)) * s
    h_prime = h / 60.0
    x = c * (1.0 - jnp.abs(jnp.mod(h_prime, 2.0) - 1.0))

    zero = jnp.zeros_like(c)
    sector = jnp.clip(jnp.floor(h_prime), 0, 5).astype(jnp.int32)
    # r,g,b per sector: [c,x,0],[x,c,0],[0,c,x],[0,x,c],[x,0,c],[c,0,x]
    r = jnp.select([sector == 0, sector == 1, sector == 2,
                    sector == 3, sector == 4, sector == 5],
                   [c, x, zero, zero, x, c], zero)
    g = jnp.select([sector == 0, sector == 1, sector == 2,
                    sector == 3, sector == 4, sector == 5],
                   [x, c, c, x, zero, zero], zero)
    b = jnp.select([sector == 0, sector == 1, sector == 2,
                    sector == 3, sector == 4, sector == 5],
                   [zero, zero, x, c, c, x], zero)
    out = jnp.stack([r, g, b], axis=-1)
    # Out-of-range hue -> black, as in the reference's fall-through arm.
    return jnp.where((h_prime >= 0.0)[..., None] & (h_prime <= 6.0)[..., None],
                     out, jnp.zeros_like(out))
