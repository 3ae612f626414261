"""Counter-based, order-invariant RNG for wavefront path tracing.

The reference uses one global `fastrand` stream seeded once
(src/main.rs:86, src/math.rs:244-246); every thread advances it
independently, so renders are only reproducible in expectation.  A
wavefront tracer wants a *stateless* generator: every random draw is a pure
hash of ``(seed, ray_id, bounce, draw)``, so renders are bit-identical
across any tiling, mesh shape, or host count — the draw for pixel P, sample
S, bounce B does not depend on scheduling.

We use PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT
2020): 4 x u32 in, 4 decorrelated u32 out, a handful of integer ops — far
cheaper than threefry and plenty for Monte Carlo rendering.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_MUL = np.uint32(1664525)
_INC = np.uint32(1013904223)
_INV_2_24 = np.float32(1.0 / 16777216.0)


def pcg4d(x, y, z, w):
    """PCG4D hash: four u32 arrays -> four decorrelated u32 arrays."""
    x = x * _MUL + _INC
    y = y * _MUL + _INC
    z = z * _MUL + _INC
    w = w * _MUL + _INC
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def _to_unit_float(u):
    """u32 -> float32 in [0, 1) using the top 24 bits."""
    return (u >> jnp.uint32(8)).astype(jnp.float32) * _INV_2_24


class Sampler:
    """Per-ray random stream indexed by (seed, ray_id, salt, draw).

    The Python-side ``draw`` counter is static at trace time, so each call
    site in the shading code gets an independent, schedule-invariant
    stream.  ``ray_id`` is any integer array; outputs broadcast to its
    shape.
    """

    def __init__(self, seed, ray_id, salt=0):
        self.seed = jnp.asarray(seed).astype(jnp.uint32)
        self.ray_id = jnp.asarray(ray_id).astype(jnp.uint32)
        self.salt = jnp.asarray(salt).astype(jnp.uint32)
        self._draw = 0

    def next4(self):
        """Four independent uniform [0,1) floats, each ray_id-shaped."""
        draw = jnp.uint32(self._draw)
        self._draw += 1
        x, y, z, w = pcg4d(
            self.ray_id,
            self.salt + jnp.uint32(0x9E3779B9) * draw,
            self.seed,
            jnp.full_like(self.ray_id, draw) ^ (self.seed << jnp.uint32(8)),
        )
        return (_to_unit_float(x), _to_unit_float(y),
                _to_unit_float(z), _to_unit_float(w))

    def next3(self):
        a, b, c, _ = self.next4()
        return a, b, c

    def next2(self):
        a, b, _, _ = self.next4()
        return a, b

    def next1(self):
        a, _, _, _ = self.next4()
        return a

    def skip(self, n=1):
        """Advance the draw counter without emitting ops.  Draws are
        pure functions of the counter, so optimisations that elide a
        consumer can keep every later stream identical for free."""
        self._draw += n
