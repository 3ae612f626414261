"""Environment backgrounds: what escaped rays see.

Mirrors the reference's Background trait family (src/material.rs:29-190):
SolidBackground, SkyBackground (the RTIOW gradient), SkySphere (equirect
env map) and CubeMap (6-face env map with rotation).  Each background is a
pytree dataclass with a batched ``eval(directions) -> rgb`` method.

Texture-backed backgrounds reference the scene's texture atlas lazily: the
integrator passes the atlas in at eval time so backgrounds stay small
pytrees.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..utils import struct

from ..math import vec


@struct.dataclass
class SolidBackground:
    color: jnp.ndarray  # (3,)

    @classmethod
    def create(cls, color):
        return cls(color=jnp.asarray(color, jnp.float32))

    def eval(self, directions, atlas=None):
        return jnp.broadcast_to(self.color, directions.shape)


@struct.dataclass
class SkyBackground:
    """White-to-blue vertical gradient (reference: material.rs:55-63)."""

    @classmethod
    def create(cls):
        return cls()

    def eval(self, directions, atlas=None):
        u = vec.unit(directions)
        t = 0.5 * (u[..., 1] + 1.0)
        white = jnp.ones(3, jnp.float32)
        blue = jnp.asarray([0.5, 0.7, 1.0], jnp.float32)
        return (white * (1.0 - t)[..., None]) + (blue * t[..., None])


@struct.dataclass
class SkySphere:
    """Equirectangular environment map (reference: material.rs:65-89)."""
    tex: jnp.ndarray  # scalar int32 texture id

    @classmethod
    def create(cls, tex_id):
        return cls(tex=jnp.asarray(tex_id, jnp.int32))

    def eval(self, directions, atlas=None):
        p = vec.unit(directions)
        theta = jnp.arccos(jnp.clip(p[..., 1], -1.0, 1.0))
        phi = jnp.arctan2(-p[..., 2], p[..., 0]) + np.pi
        u = phi / (2.0 * np.pi)
        v = theta / np.pi
        uv = jnp.stack([u, v], axis=-1)
        rgba = atlas.sample(jnp.broadcast_to(self.tex, u.shape), uv)
        return rgba[..., :3]


@struct.dataclass
class CubeMap:
    """Six-face environment map with rotation (reference: material.rs:91-190).

    ``faces`` is stored in constructor-argument order
    [x_pos, x_neg, y_pos, y_neg, z_pos, z_neg] and the dominant-axis
    selection computes the same face *index* as the reference
    (material.rs:141-174) — including its quirk of picking index 3 (y_neg
    texture) for +y directions and index 2 (y_pos) for -y, so env maps
    authored against the reference render identically.

    ``transform`` is applied to the ray direction before face selection.
    The reference constructs its rotation from three rotate_x calls
    (material.rs:103-105) — an apparent bug we do NOT replicate; callers
    pass any 4x4 here.
    """
    faces: jnp.ndarray      # (6,) int32 texture ids, ctor order
    transform: jnp.ndarray  # (4,4)
    # Static: all six face rows are RAW atlas rows (e.g. baked by
    # envmaps.environment) -> eval takes the single-gather sample path
    # (bit-identical; one texel gather per eval instead of two).
    faces_raw: bool = struct.field(pytree_node=False, default=False)

    @classmethod
    def create(cls, x_pos, x_neg, y_pos, y_neg, z_pos, z_neg,
               transform=None, faces_raw=False):
        faces = jnp.asarray([x_pos, x_neg, y_pos, y_neg, z_pos, z_neg],
                            jnp.int32)
        if transform is None:
            transform = jnp.eye(4, dtype=jnp.float32)
        return cls(faces=faces,
                   transform=jnp.asarray(transform, jnp.float32),
                   faces_raw=faces_raw)

    def eval(self, directions, atlas=None):
        # Explicit broadcast dot: an einsum here lowers to a dot_general
        # that XLA treats as a fusion boundary in the middle of the
        # bounce loop (as in spheres.nearest_t);
        # three fused multiply-adds are bit-identical (same
        # left-to-right contraction order) and free.
        R = self.transform[:3, :3]
        p = (directions[..., 0:1] * R[:, 0] + directions[..., 1:2] * R[:, 1]
             + directions[..., 2:3] * R[:, 2])
        ax, ay, az = jnp.abs(p[..., 0]), jnp.abs(p[..., 1]), jnp.abs(p[..., 2])
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]

        is_x = (ax >= ay) & (ax >= az)
        is_y = (~is_x) & (ay >= ax) & (ay >= az)
        is_z = ~(is_x | is_y)

        # Per-face (index, u, v, max_axis) following material.rs:141-174.
        index = jnp.where(
            is_x, jnp.where(px > 0, 0, 1),
            jnp.where(is_y, jnp.where(py > 0, 3, 2),
                      jnp.where(pz > 0, 4, 5)))
        u = jnp.where(
            is_x, jnp.where(px > 0, -pz, pz),
            jnp.where(is_y, px, jnp.where(pz > 0, px, -px)))
        v = jnp.where(
            is_x, py,
            jnp.where(is_y, jnp.where(py > 0, -pz, pz), py))
        max_axis = jnp.where(is_x, ax, jnp.where(is_y, ay, az))

        uu = 0.5 * (u / max_axis + 1.0)
        vv = 0.5 * (v / max_axis + 1.0)
        uv = jnp.stack([uu, vv], axis=-1)
        tex_ids = self.faces[index]
        rgba = atlas.sample(tex_ids, uv, raw=self.faces_raw)
        return rgba[..., :3]
