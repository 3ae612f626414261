"""Instanced statue grid (reference: src/scenes/lucy.rs:29-95).

11x11 instances of a statue mesh with random y rotations and random
pastel Lambertians, on a white cube ground, lit by a huge distant sun
sphere, black background, camera 40deg from (6,8,5).

The reference loads `models/lucy.ply` (the Stanford Lucy scan, not
shipped with the repo) with the axis swizzle (x,y,z)->(y,z,x) and
normalises by the largest |coordinate|.  When the asset is absent a
procedural stand-in statue (stacked-sphere figure) keeps the scene
runnable; drop lucy.ply into models/ for the real thing.
"""

from __future__ import annotations

import os

import numpy as np

from . import register
from ..core.camera import Camera
from ..geometry.scene import SceneBuilder
from ..geometry.shapes import cube, sphere_mesh
from ..geometry.triangles import Triangles
from ..materials.table import MaterialBuilder
from ..materials.background import SolidBackground


def _load_lucy(path):
    """lucy.rs:33-42: swizzle (x,y,z)->(y,z,x), track max |component|."""
    from ..loaders import load_ply

    verts, faces = load_ply(path)
    max_dim = np.abs(verts).max() if verts.size else 1.0
    verts = verts[:, [1, 2, 0]]
    return Triangles.build(verts, faces), float(max_dim)


def _standin_statue():
    """A simple stacked-spheres figure spanning roughly [-1,1]."""
    parts = []
    for center, radius in [((0, -0.55, 0), 0.45), ((0, 0.05, 0), 0.35),
                           ((0, 0.5, 0), 0.25), ((0, 0.85, 0), 0.15)]:
        parts.append(sphere_mesh(center, radius, lat=8, lon=12))
    import jax
    tris = jax.tree.map(lambda *xs: np.concatenate(xs, 0), *parts)
    return tris, 1.0


@register("lucy")
class Lucy:
    def __init__(self, aspect_ratio=16.0 / 9.0, seed=1,
                 asset="models/lucy.ply", grid=5):
        self.aspect_ratio = aspect_ratio
        self.seed = seed
        self.asset = asset
        self.grid = grid

    def generate(self, t=0.0, frame=0, input=None):
        rng = np.random.default_rng(self.seed)
        mat = MaterialBuilder()
        white = mat.lambertian((1.0, 1.0, 1.0))
        sun = mat.diffuse_light((40.0, 40.0, 50.0))

        sb = SceneBuilder(mat, SolidBackground.create((0, 0, 0)))
        ground = sb.add_mesh(cube(size=2.0))
        sb.add_instance(ground, (0.0, -1000.0, 0.0), scale=1000.0,
                        material=white)

        from ..runtime.assets import resolve
        asset = resolve(self.asset)
        if os.path.exists(asset):
            statue, max_dim = _load_lucy(asset)
        else:
            statue, max_dim = _standin_statue()
        # SAH trees cut node visits on the irregular statue, with
        # bit-identical means.  MRT_BVH=median overrides.
        statue_mesh = sb.add_mesh(statue, split="sah")

        g = self.grid
        for x in range(-g, g + 1):
            for z in range(-g, g + 1):
                color = tuple(1.0 - rng.random(3) * 0.5)
                sb.add_instance(
                    statue_mesh, (x * 3.0, 1.0, z * 3.0),
                    rotation=(0.0, float(rng.random()), 0.0),
                    scale=2.0 / max_dim,
                    material=mat.lambertian(color))

        sb.add_sphere((10000.0, 4000.0, 4800.0), 1500.0, sun)

        camera = Camera.create(
            40.0, (6.0, 8.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
            self.aspect_ratio, aperture=0.0,
            focus_distance=float(np.linalg.norm([6.0, 8.0, 5.0])))
        return sb.build(), camera
