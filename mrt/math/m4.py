"""4x4 affine transforms with the reference's *turns* angle convention.

The reference stores M4 column-major and composes `translation * rotation *
scale` (reference: src/math/generic.rs:71-177, src/geom.rs:344-367).  Here an
M4 is a plain (4, 4) array in standard math orientation, i.e.
``transform_point(m, p) == (m @ [p, 1])[:3]`` — identical semantics to the
reference's column-of-V4 layout.

Rotation angles are in **turns** (angle * 2*pi radians), matching the
reference (src/math.rs:184-215) — scenes written against the reference's
numeric conventions reproduce exactly.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

TAU = 2.0 * np.pi
# Full f32 products: a GPU would otherwise be free to use TF32.
HIGHEST = jax.lax.Precision.HIGHEST


def identity():
    return jnp.eye(4, dtype=jnp.float32)


def translation(t):
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(jnp.asarray(t, jnp.float32))


def rotate_x(turns):
    a = jnp.asarray(turns, jnp.float32) * TAU
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        jnp.float32).at[1, 1].set(c).at[1, 2].set(-s).at[2, 1].set(s).at[2, 2].set(c)


def rotate_y(turns):
    a = jnp.asarray(turns, jnp.float32) * TAU
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        jnp.float32).at[0, 0].set(c).at[0, 2].set(s).at[2, 0].set(-s).at[2, 2].set(c)


def rotate_z(turns):
    a = jnp.asarray(turns, jnp.float32) * TAU
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        jnp.float32).at[0, 0].set(c).at[0, 1].set(-s).at[1, 0].set(s).at[1, 1].set(c)


def scale(s):
    s = jnp.asarray(s, jnp.float32)
    s = jnp.broadcast_to(s, (3,))
    return jnp.diag(jnp.concatenate([s, jnp.ones((1,), jnp.float32)]))


def matmul(*ms):
    """Product of 4x4 matrices, left to right, in full f32."""
    out = ms[0]
    for m in ms[1:]:
        out = jnp.matmul(out, m, precision=HIGHEST)
    return out


def transform_point(m, p):
    """Apply m to points p of shape (..., 3) with w=1."""
    return (jnp.einsum("ij,...j->...i", m[:3, :3], p,
                       precision=HIGHEST)
            + m[:3, 3])


def transform_vector(m, v):
    """Apply m's linear part to vectors v of shape (..., 3) (w=0)."""
    return jnp.einsum("ij,...j->...i", m[:3, :3], v,
                      precision=HIGHEST)


def trs(translation_v, rotation_turns, scale_v):
    """T * Rx * Ry * Rz * S, exactly the reference's Instance composition
    (src/geom.rs:344-367)."""
    return matmul(translation(translation_v),
                  rotate_x(rotation_turns[0]),
                  rotate_y(rotation_turns[1]),
                  rotate_z(rotation_turns[2]),
                  scale(scale_v))


def trs_inverse(translation_v, rotation_turns, scale_v):
    """S^-1 * Rz^-1 * Ry^-1 * Rx^-1 * T^-1: the reference composes the
    inverse from negated components (src/geom.rs:344-367) rather than
    inverting the matrix."""
    t = jnp.asarray(translation_v, jnp.float32)
    r = jnp.asarray(rotation_turns, jnp.float32)
    s = jnp.asarray(scale_v, jnp.float32)
    s = jnp.broadcast_to(s, (3,))
    return matmul(scale(1.0 / s), rotate_z(-r[2]), rotate_y(-r[1]),
                  rotate_x(-r[0]), translation(-t))


# -- batched host-side constructors (numpy) ---------------------------------
# Scene builds compose millions of instance transforms (e.g. the Menger
# sponge's 3.2M cubes, scenes/menger.rs); per-instance jnp math would be
# a Python-loop catastrophe, so these build (I,4,4) arrays vectorised.

def _rot_batch_np(turns, axis):
    import numpy as _np

    a = _np.asarray(turns, _np.float32) * TAU
    c, s = _np.cos(a), _np.sin(a)
    n = a.shape[0]
    m = _np.tile(_np.eye(4, dtype=_np.float32), (n, 1, 1))
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[:, i, i] = c
    m[:, j, j] = c
    if axis == 1:  # y: +s above diagonal
        m[:, i, j] = s
        m[:, j, i] = -s
    else:
        m[:, i, j] = -s
        m[:, j, i] = s
    return m


def trs_batch_np(translation, rotation_turns, scale):
    """Batched T @ Rx @ Ry @ Rz @ S (geom.rs:344-367), numpy (I,4,4)."""
    import numpy as _np

    t = _np.asarray(translation, _np.float32)
    r = _np.asarray(rotation_turns, _np.float32)
    s = _np.asarray(scale, _np.float32)
    n = t.shape[0]
    rot = (_rot_batch_np(r[:, 0], 0) @ _rot_batch_np(r[:, 1], 1)
           @ _rot_batch_np(r[:, 2], 2))
    m = rot.copy()
    m[:, :3, :3] *= s[:, None, :]      # right-multiply by scale
    m[:, :3, 3] = t                    # left-multiply by translation
    return m


def trs_inverse_batch_np(translation, rotation_turns, scale):
    """Batched S^-1 @ Rz^-1 @ Ry^-1 @ Rx^-1 @ T^-1, numpy (I,4,4)."""
    import numpy as _np

    t = _np.asarray(translation, _np.float32)
    r = _np.asarray(rotation_turns, _np.float32)
    s = _np.asarray(scale, _np.float32)
    rot = (_rot_batch_np(-r[:, 2], 2) @ _rot_batch_np(-r[:, 1], 1)
           @ _rot_batch_np(-r[:, 0], 0))
    m = rot.copy()
    m[:, :3, :3] /= s[:, :, None]      # left-multiply by inverse scale
    m[:, :3, 3] = -_np.einsum("nij,nj->ni", m[:, :3, :3], t)
    return m
