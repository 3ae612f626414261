"""Menger sponge (reference: src/scenes/menger.rs:68-124).

20^level instanced cubes in the Menger corner/edge pattern, a vast
fuzzy-metal floor, and the star+nebula environment cube map, camera
15deg from (2680,140,2000).

The reference hardcodes five nested subdivision loops (20^5 = 3.2M
cubes, menger.rs:86-103); `level` counts those loops (default 5), a parameter
here — lower levels render the same structure smaller for
tests and previews.
"""

from __future__ import annotations

import numpy as np

from . import register
from ..core.camera import Camera
from ..geometry.scene import SceneBuilder
from ..geometry.shapes import cube
from ..materials.table import MaterialBuilder
from .envmaps import environment
from ..textures.atlas import AtlasBuilder

# The 20 of 27 sub-cells kept by the sponge (menger.rs:105-126).
_SIDES = [(0, 1, 1), (1, 0, 1), (1, 1, 0), (0, -1, -1), (-1, 0, -1),
          (-1, -1, 0), (0, -1, 1), (-1, 0, 1), (-1, 1, 0), (0, 1, -1),
          (1, 0, -1), (1, -1, 0), (-1, -1, 1), (-1, 1, -1), (1, -1, -1),
          (-1, 1, 1), (1, -1, 1), (1, 1, -1), (1, 1, 1), (-1, -1, -1)]


def sponge_positions(level, dims=2.0):
    """All cube centers for a level-n sponge (menger.rs:86-103)."""
    sides = np.asarray(_SIDES, np.float64)
    pos = np.zeros((1, 3))
    for lv in range(level - 1, -1, -1):
        step = dims * (3.0 ** lv)
        pos = (pos[:, None, :] + sides[None, :, :] * step).reshape(-1, 3)
    return pos.astype(np.float32)


def sponge_occupancy(level):
    """(n,n,n) bool occupancy of a level-n sponge block, n = 3^level.

    Cell (i,j,k) is solid iff at no base-3 digit position do >= 2 of the
    three coordinates have digit 1 — the closed form of the 20-of-27
    recursion (menger.rs:105-126; `_SIDES` keeps exactly the cells whose
    offset triple has at most one zero).
    """
    n = 3 ** level
    idx = np.arange(n)
    solid = np.ones((n, n, n), bool)
    for lv in range(level):
        dig = (idx // 3 ** lv) % 3
        di = (dig == 1)[:, None, None]
        dj = (dig == 1)[None, :, None]
        dk = (dig == 1)[None, None, :]
        bad = (di.astype(np.int8) + dj.astype(np.int8)
               + dk.astype(np.int8)) >= 2
        solid &= ~bad
    return solid


def _greedy_rects(mask):
    """Greedy maximal-rectangle cover of a 2D bool mask.

    Returns (i0, j0, h, w) int arrays.  The classic voxel-mesher sweep:
    scan rows, extend each unclaimed run right then down.
    """
    m = mask.copy()
    out = []
    height, width = m.shape
    for i in range(height):
        j = 0
        row = m[i]
        while j < width:
            if not row[j]:
                j += 1
                continue
            w = 1
            while j + w < width and row[j + w]:
                w += 1
            h = 1
            while i + h < height and m[i + h, j:j + w].all():
                h += 1
            m[i:i + h, j:j + w] = False
            out.append((i, j, h, w))
            j += w
    return out


def sponge_block_mesh(bake, dims=2.0, material=0):
    """A level-`bake` sponge block baked into one greedy-meshed surface.

    Replaces 20^bake instanced 12-triangle cubes with the identical
    *surface*: interior faces (coincident faces of touching cubes) are
    culled and coplanar exposed faces merged into maximal rectangles —
    e.g. bake=2 turns 400 cubes / 4800 tris into 1176 tris.  Pure NumPy;
    flat normals, no UVs, exactly like the reference's cube.ply loaded
    with `Triangle::new((), a, b, c)` (menger.rs:72, no normals/uvs).
    """
    from ..geometry.triangles import Triangles

    occ = sponge_occupancy(bake)
    n = occ.shape[0]
    lo = -n * dims / 2.0

    va, vb, vc = [], [], []
    for axis in range(3):
        occ_a = np.moveaxis(occ, axis, 0)          # (slice, u, v)
        pad = np.zeros((n + 2, n, n), bool)
        pad[1:-1] = occ_a
        for sign, exposed in ((-1.0, occ_a & ~pad[:-2]),
                              (1.0, occ_a & ~pad[2:])):
            for sl in range(n):
                plane = lo + (sl + (sign > 0)) * dims
                for (i0, j0, h, w) in _greedy_rects(exposed[sl]):
                    # Rect spans cells [i0,i0+h) x [j0,j0+w) in the
                    # (axis+1, axis+2) plane.
                    u0, u1 = lo + i0 * dims, lo + (i0 + h) * dims
                    v0, v1 = lo + j0 * dims, lo + (j0 + w) * dims
                    corner = np.zeros((4, 3), np.float32)
                    corner[:, axis] = plane
                    ua, vb_ax = (axis + 1) % 3, (axis + 2) % 3
                    corner[:, ua] = (u0, u1, u1, u0)
                    corner[:, vb_ax] = (v0, v0, v1, v1)
                    if sign > 0:
                        a, b, c, d = corner[0], corner[1], corner[2], \
                            corner[3]
                    else:  # flip winding so the flat normal points out
                        a, b, c, d = corner[0], corner[3], corner[2], \
                            corner[1]
                    va += [a, a]
                    vb += [b, c]
                    vc += [c, d]
    return Triangles.from_soup(np.stack(va), np.stack(vb), np.stack(vc),
                               material=material)


@register("menger")
class Menger:
    """The sponge body renders through one of two equivalent paths:

    voxel=True (default): a single procedural `VoxelGrid` — the sponge's
    cubes exactly tile a 3^level grid whose occupancy is the closed-form
    digit rule (sponge_occupancy), so the closest hit is a gather-free
    hierarchical DDA (geometry/voxels.py): the path that renders the
    reference's 3.2M-cube level-5 scene without a BVH.

    voxel=False: instanced triangle meshes via the TLAS — `bake` levels
    fused into one greedy-meshed block (sponge_block_mesh), the
    remaining `level - bake` levels instanced; (5, 2) is 8000 instances
    of a 1176-triangle block, identical surface.  bake=0 reproduces the
    literal per-cube instancing (menger.rs:86-103).  Kept as the
    general-TLAS stress path."""

    def __init__(self, aspect_ratio=16.0 / 9.0, level=5, bake=2,
                 voxel=True):
        self.aspect_ratio = aspect_ratio
        self.level = level
        self.bake = min(bake, level)
        self.voxel = voxel

    def generate(self, t=0.0, frame=0, input=None):
        mat = MaterialBuilder()
        atlas = AtlasBuilder()
        white = mat.lambertian((1.0, 1.0, 1.0))
        foggy = mat.metal(0.7, (0.5, 0.5, 0.5))

        background = environment(atlas, "j02", rotation=(0.4, 0.2, 0.1))
        sb = SceneBuilder(mat, background, atlas=atlas.build())

        if self.voxel:
            half = 2.0 * 3.0 ** self.level / 2.0
            sb.add_voxel_grid(origin=(-half, -half, -half), cell=2.0,
                              levels=self.level, material=white)
        else:
            bake = self.bake
            if bake > 0:
                block = sb.add_mesh(sponge_block_mesh(bake, dims=2.0))
                for p in sponge_positions(self.level - bake,
                                          dims=2.0 * 3.0 ** bake):
                    sb.add_instance(block, tuple(p), material=white)
        mesh = sb.add_mesh(cube(size=2.0))
        if not self.voxel and self.bake == 0:
            for p in sponge_positions(self.level):
                sb.add_instance(mesh, tuple(p), material=white)

        sb.add_instance(mesh, (0.0, -244.0, 0.0),
                        scale=(500000.0, 1.0, 500000.0), material=foggy)

        look_from = (2680.0, 140.0, 2000.0)
        camera = Camera.create(
            15.0, look_from, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
            self.aspect_ratio, aperture=0.0,
            focus_distance=float(np.linalg.norm(look_from)))
        return sb.build(), camera
