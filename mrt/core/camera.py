"""Thin-lens camera with defocus blur.

Same optical model as the reference (src/world.rs:5-63): vertical FOV in
degrees, look-from/look-at/view-up basis, aperture + focus distance, and
*unnormalised* ray directions (the reference never normalises primary ray
directions; t_min/t_max are in the same parameterisation, so we keep that
convention exactly).

The camera is a pytree, so all parameters are differentiable and the whole
struct can be donated to jit.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..utils import struct

from ..math import vec, sampling


@struct.dataclass
class Camera:
    origin: jnp.ndarray        # (3,)
    lower_left: jnp.ndarray    # (3,)
    horizontal: jnp.ndarray    # (3,)
    vertical: jnp.ndarray      # (3,)
    u: jnp.ndarray             # (3,) lens basis
    v: jnp.ndarray             # (3,)
    lens_radius: jnp.ndarray   # scalar

    @classmethod
    def create(cls, vertical_fov_deg, look_from, look_at, view_up,
               aspect_ratio, aperture=0.0, focus_distance=1.0):
        look_from = jnp.asarray(look_from, jnp.float32)
        look_at = jnp.asarray(look_at, jnp.float32)
        view_up = jnp.asarray(view_up, jnp.float32)

        theta = jnp.asarray(vertical_fov_deg, jnp.float32) * (np.pi / 180.0)
        half_height = jnp.tan(theta / 2.0)
        viewport_height = 2.0 * half_height
        viewport_width = aspect_ratio * viewport_height

        w = vec.unit(look_from - look_at)
        u = vec.unit(vec.cross(view_up, w))
        v = vec.cross(w, u)

        origin = look_from
        horizontal = u * (viewport_width * focus_distance)
        vertical = v * (viewport_height * focus_distance)
        lower_left = (origin - horizontal / 2.0 - vertical / 2.0
                      - w * focus_distance)

        return cls(origin=origin, lower_left=lower_left,
                   horizontal=horizontal, vertical=vertical, u=u, v=v,
                   lens_radius=jnp.asarray(aperture, jnp.float32) / 2.0)

    def rays(self, s, t, du, dv):
        """Generate rays for viewport coords s,t in [0,1] (t up).

        du, dv are uniforms in [0,1) driving the defocus-disk sample
        (reference: world.rs:53-63).  Returns (origins, directions), each
        (..., 3); directions are unnormalised.
        """
        blur = sampling.in_unit_disk(du, dv) * self.lens_radius
        offset = (self.u * blur[..., 0:1]) + (self.v * blur[..., 1:2])
        origin = self.origin + offset
        direction = (self.lower_left
                     + self.horizontal * s[..., None]
                     + self.vertical * t[..., None]
                     - self.origin - offset)
        return origin, direction
