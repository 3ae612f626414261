"""Character physics against level collision geometry (host-side).

The reference's Mario scene hands its level mesh to libsm64 and ticks a
physics engine per frame (reference: src/scenes/mario.rs:47-89 level
ingestion, mario.rs:204 `handle.tick(input)`); libsm64 is a C library
driven by a game ROM neither of which is available here, so this module
is a from-scratch equivalent: a triangle-soup collision structure fed
from the OBJ loader and a capsule character controller (gravity, ground
detection, jumping, moving-platform carry) ticked once per frame from an
`InputCollection`.  All NumPy: physics is inherently sequential
single-body work and belongs on host, not the accelerator.

The capsule is resolved as two spheres on its axis (feet + chest); each
tick integrates velocity, then iteratively pushes the spheres out of the
closest triangles (Ericson-style closest-point-on-triangle, vectorised
over the whole soup), accumulating ground contact from upward-facing
contact normals.  Deterministic: state' = f(state, input, colliders)
with no RNG, so a replayed input recording reproduces the run bit-for-
bit (mario.rs:318-343 record/replay contract).
"""

from __future__ import annotations

import dataclasses

import numpy as np

GRAVITY = -30.0
RUN_SPEED = 8.0
AIR_CONTROL = 0.35
JUMP_SPEED = 12.0
DT = 1.0 / 30.0
GROUND_COS = 0.7          # contact normal y above this counts as ground
SOLVER_ITERS = 4


def closest_point_on_triangles(p, va, vb, vc):
    """Closest point to `p` on each triangle (Ericson, Real-Time
    Collision Detection 5.1.5), vectorised over a (T,3) soup with the
    book's exact region tests applied in priority order.  Returns (T,3).
    """
    ab = vb - va
    ac = vc - va
    ap = p[None, :] - va
    d1 = np.einsum("td,td->t", ab, ap)
    d2 = np.einsum("td,td->t", ac, ap)

    bp = p[None, :] - vb
    d3 = np.einsum("td,td->t", ab, bp)
    d4 = np.einsum("td,td->t", ac, bp)

    cp = p[None, :] - vc
    d5 = np.einsum("td,td->t", ab, cp)
    d6 = np.einsum("td,td->t", ac, cp)

    va_ = d3 * d6 - d5 * d4
    vb_ = d5 * d2 - d1 * d6
    vc_ = d1 * d4 - d3 * d2

    with np.errstate(divide="ignore", invalid="ignore"):
        v_ab = np.nan_to_num(d1 / (d1 - d3))
        w_ac = np.nan_to_num(d2 / (d2 - d6))
        w_bc = np.nan_to_num((d4 - d3) / ((d4 - d3) + (d5 - d6)))
        denom = va_ + vb_ + vc_
        v_in = np.nan_to_num(vb_ / denom)
        w_in = np.nan_to_num(vc_ / denom)

    t = va.shape[0]
    out = np.zeros_like(va)
    done = np.zeros(t, bool)

    def take(mask, value):
        nonlocal out, done
        m = mask & ~done
        out = np.where(m[:, None], value, out)
        done |= m

    take((d1 <= 0) & (d2 <= 0), va)                       # vertex A
    take((d3 >= 0) & (d4 <= d3), vb)                      # vertex B
    take((vc_ <= 0) & (d1 >= 0) & (d3 <= 0),
         va + ab * np.clip(v_ab, 0, 1)[:, None])          # edge AB
    take((d6 >= 0) & (d5 <= d6), vc)                      # vertex C
    take((vb_ <= 0) & (d2 >= 0) & (d6 <= 0),
         va + ac * np.clip(w_ac, 0, 1)[:, None])          # edge AC
    take((va_ <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
         vb + (vc - vb) * np.clip(w_bc, 0, 1)[:, None])   # edge BC
    take(np.ones(t, bool),
         va + ab * v_in[:, None] + ac * w_in[:, None])    # interior
    return out


class CollisionMesh:
    """Triangle-soup collision set (the libsm64 LevelTriangle role,
    mario.rs:279-316)."""

    def __init__(self, va, vb, vc):
        self.va = np.asarray(va, np.float64)
        self.vb = np.asarray(vb, np.float64)
        self.vc = np.asarray(vc, np.float64)

    @classmethod
    def from_triangles(cls, tris):
        va = np.asarray(tris.va, np.float64)
        vb = va + np.asarray(tris.e_ab, np.float64)
        vc = va + np.asarray(tris.e_ac, np.float64)
        return cls(va, vb, vc)

    def transformed(self, m4):
        """Apply a 4x4 transform (for dynamic surfaces, mario.rs:143-155)."""
        m = np.asarray(m4, np.float64)
        f = lambda v: v @ m[:3, :3].T + m[:3, 3]
        return CollisionMesh(f(self.va), f(self.vb), f(self.vc))

    def concat(self, other):
        return CollisionMesh(
            np.concatenate([self.va, other.va]),
            np.concatenate([self.vb, other.vb]),
            np.concatenate([self.vc, other.vc]))

    @property
    def count(self):
        return self.va.shape[0]


@dataclasses.dataclass
class CharacterState:
    pos: np.ndarray          # capsule foot-sphere center
    vel: np.ndarray
    grounded: bool = False
    phase: float = 0.0       # run-cycle phase (drives the posed mesh)

    @classmethod
    def spawn(cls, pos):
        return cls(pos=np.asarray(pos, np.float64),
                   vel=np.zeros(3))


RADIUS = 0.45
CAPSULE_SEGMENT = 0.9     # chest sphere sits this far above the foot


def _resolve_sphere(center, vel, colliders, radius):
    """Push a sphere out of the soup; returns (center, vel, ground)."""
    grounded = False
    for _ in range(SOLVER_ITERS):
        q = closest_point_on_triangles(center, colliders.va,
                                       colliders.vb, colliders.vc)
        delta = center[None, :] - q
        dist2 = np.einsum("td,td->t", delta, delta)
        i = int(np.argmin(dist2))
        d2 = dist2[i]
        if d2 >= radius * radius or d2 < 1e-18:
            break
        d = np.sqrt(d2)
        n = delta[i] / d
        center = center + n * (radius - d)
        vn = float(np.dot(vel, n))
        if vn < 0.0:
            vel = vel - n * vn       # slide along the surface
        if n[1] > GROUND_COS:
            grounded = True
    return center, vel, grounded


def tick(state: CharacterState, inp, colliders: CollisionMesh,
         platform_velocity=None) -> CharacterState:
    """One physics frame (the handle.tick(input) equivalent,
    mario.rs:204).

    inp: runtime.input.InputCollection (None = neutral).
    platform_velocity: world velocity of the surface under the
    character (moving-platform carry, the DynamicSurface role).
    """
    pos = state.pos.copy()
    vel = state.vel.copy()

    sx = float(inp.stick_x) if inp is not None else 0.0
    sy = float(inp.stick_y) if inp is not None else 0.0
    jump = bool(inp.button_a) if inp is not None else False

    want = np.array([sx * RUN_SPEED, 0.0, -sy * RUN_SPEED])
    blend = 1.0 if state.grounded else AIR_CONTROL
    vel[0] += (want[0] - vel[0]) * blend
    vel[2] += (want[2] - vel[2]) * blend

    if jump and state.grounded:
        vel[1] = JUMP_SPEED
    vel[1] += GRAVITY * DT

    carry = (np.asarray(platform_velocity, np.float64)
             if platform_velocity is not None and state.grounded
             else np.zeros(3))

    # Substep so no single move exceeds a fraction of the radius —
    # otherwise a fast fall tunnels through a face and the closest-point
    # resolve pushes out the far side.
    move = (vel + carry) * DT
    n_sub = max(1, int(np.ceil(np.linalg.norm(move) / (RADIUS * 0.4))))
    grounded = False
    up = np.array([0.0, CAPSULE_SEGMENT, 0.0])
    for _ in range(n_sub):
        pos = pos + (vel + carry) * (DT / n_sub)
        pos, vel, g0 = _resolve_sphere(pos, vel, colliders, RADIUS)
        chest = pos + up
        chest, vel, _ = _resolve_sphere(chest, vel, colliders, RADIUS)
        pos = chest - up
        grounded = grounded or g0
    g0 = grounded

    speed = float(np.hypot(vel[0], vel[2]))
    phase = state.phase + speed * DT * 1.6
    return CharacterState(pos=pos, vel=vel, grounded=g0, phase=phase)
