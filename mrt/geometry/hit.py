"""SoA hit records for a wavefront of rays.

The reference's `Hit` (src/geom.rs:7-33) is one struct per ray with a
`&dyn Material`; here a wavefront of N rays produces parallel arrays and
materials are integer rows into the scene's MaterialTable.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

INF = float("inf")  # python float: no backend init at import time


@struct.dataclass
class Hits:
    t: jnp.ndarray           # (N,)  +inf on miss
    point: jnp.ndarray       # (N,3)
    normal: jnp.ndarray      # (N,3) front-faced (flipped against ray)
    front_face: jnp.ndarray  # (N,)  bool
    uv: jnp.ndarray          # (N,2) zeros when the primitive has no UVs
    material: jnp.ndarray    # (N,)  int32 MaterialTable row
    hit: jnp.ndarray         # (N,)  bool
    # Tangent frame for normal mapping (geom.rs:554-561); zeros for
    # primitives without UVs (spheres, volumes).
    tangent: jnp.ndarray     # (N,3)
    bitangent: jnp.ndarray   # (N,3)
    # Light-pdf geometry of the hit primitive (for MIS, materials/
    # lights.py): > 0 = world-space triangle area, < 0 = -sphere_radius,
    # 0 = n/a (volumes, misses).
    prim_area: jnp.ndarray = None   # (N,)

    @classmethod
    def none(cls, n):
        """All-miss record for n rays."""
        return cls(
            t=jnp.full((n,), INF),
            point=jnp.zeros((n, 3), jnp.float32),
            normal=jnp.zeros((n, 3), jnp.float32),
            front_face=jnp.zeros((n,), bool),
            uv=jnp.zeros((n, 2), jnp.float32),
            material=jnp.zeros((n,), jnp.int32),
            hit=jnp.zeros((n,), bool),
            tangent=jnp.zeros((n, 3), jnp.float32),
            bitangent=jnp.zeros((n, 3), jnp.float32),
            prim_area=jnp.zeros((n,), jnp.float32),
        )

    @property
    def outward_normal(self):
        """The pre-flip geometric normal (what the reference interpolates
        before set_face_normal, geom.rs:552)."""
        return jnp.where(self.front_face[:, None], self.normal,
                         -self.normal)

    def closer_of(self, other: "Hits") -> "Hits":
        """Per-ray select whichever of two hit records is nearer."""
        take_other = other.t < self.t
        tv = take_other[:, None]
        return Hits(
            t=jnp.where(take_other, other.t, self.t),
            point=jnp.where(tv, other.point, self.point),
            normal=jnp.where(tv, other.normal, self.normal),
            front_face=jnp.where(take_other, other.front_face,
                                 self.front_face),
            uv=jnp.where(take_other[:, None], other.uv, self.uv),
            material=jnp.where(take_other, other.material, self.material),
            hit=self.hit | other.hit,
            tangent=jnp.where(tv, other.tangent, self.tangent),
            bitangent=jnp.where(tv, other.bitangent, self.bitangent),
            prim_area=jnp.where(take_other, other.prim_area,
                                self.prim_area),
        )


def set_face_normal(d, outward_normal):
    """Flip outward normal against the ray (reference: geom.rs:17-24).

    Returns (normal, front_face).
    """
    front_face = jnp.sum(d * outward_normal, axis=-1) < 0.0
    normal = jnp.where(front_face[..., None], outward_normal,
                       -outward_normal)
    return normal, front_face
