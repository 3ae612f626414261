"""Environment cube-map construction (the reference's eve::environment).

The reference blends a shared tiling star texture additively with a
per-face YCbCr nebula into a CubeMap (reference: src/eve.rs:342-364).
The PNG assets are not shipped in the reference repo, so
`environment()` loads them when an asset directory is present and
otherwise synthesises deterministic placeholder star/nebula textures
with the same pipeline structure.

Note the reference's CubeMap constructor composes its rotation from
three rotate_X calls (an apparent bug: material.rs:103-105 uses
rotate_x for all three axes); `environment()` reproduces that exact
transform so renders match the reference's actual output.
"""

from __future__ import annotations

import os

import numpy as np

from ..materials.background import CubeMap
from ..math import m4
from ..textures.atlas import AtlasBuilder, ADDITION, REPEAT


def _synth_stars(rng, size=256, count=400):
    """Sparse white star dots on black, tileable."""
    img = np.zeros((size, size, 4), np.float32)
    img[..., 3] = 1.0
    ys = rng.integers(0, size, count)
    xs = rng.integers(0, size, count)
    mags = rng.random(count).astype(np.float32) ** 3
    img[ys, xs, :3] = mags[:, None]
    return img


def _synth_nebula(rng, size=128):
    """Low-frequency luma + chroma noise (stands in for the nebula
    YCbCr pair)."""
    def lowfreq(channels):
        small = rng.random((8, 8, channels)).astype(np.float32)
        reps = size // 8
        big = np.kron(small, np.ones((reps, reps, 1), np.float32))
        return big

    luma = np.zeros((size, size, 4), np.float32)
    luma[..., 0] = lowfreq(1)[..., 0] * 0.35
    luma[..., 3] = 1.0
    chroma = np.full((size, size, 4), 0.5, np.float32)
    chroma[..., :2] = 0.4 + 0.2 * lowfreq(2)
    chroma[..., 3] = 1.0
    return luma, chroma


def environment(atlas: AtlasBuilder, name="j02", rotation=(0.4, 0.2, 0.1),
                asset_root="models/environments", seed=7):
    """Build the 6-face star+nebula CubeMap (eve.rs:342-364).

    Returns a CubeMap background; texture rows are added to `atlas`.
    """
    from ..runtime.assets import resolve
    asset_root = resolve(asset_root)
    star_path = os.path.join(asset_root, "stars01_tile2.png")
    have_assets = os.path.exists(star_path)
    rng = np.random.default_rng(seed)

    if have_assets:
        stars = atlas.add_png(star_path, wrap=REPEAT)
    else:
        stars = atlas.add_raw(_synth_stars(rng), wrap=REPEAT)

    faces = []
    for index in range(6):
        if have_assets:
            luma = atlas.add_png(
                os.path.join(asset_root, name, f"{index}.png"), wrap=REPEAT)
            chroma = atlas.add_png(
                os.path.join(asset_root, name, f"{index}_chroma.png"),
                wrap=REPEAT)
        else:
            luma_px, chroma_px = _synth_nebula(rng)
            luma = atlas.add_raw(luma_px, wrap=REPEAT)
            chroma = atlas.add_raw(chroma_px, wrap=REPEAT)
        nebula = atlas.add_ycbcr(luma, chroma)
        # The reference nests combinators two deep here
        # (Blend(Addition, stars, YCbCr(...)), eve.rs:353); the atlas
        # resolves one level at sample time, so bake the addition.
        faces.append(atlas.bake_addition(stars, nebula))
    baked = faces

    # Reference quirk: rotation built from three rotate_x calls
    # (material.rs:103-105) -> net rotate_x(rx+ry+rz).
    rot = m4.matmul(m4.rotate_x(rotation[0]), m4.rotate_x(rotation[1]),
                    m4.rotate_x(rotation[2]))
    # Every face is a host-baked RAW row (bake_addition -> add_raw),
    # so eval can take the single-gather sample path.
    return CubeMap.create(*baked, transform=rot, faces_raw=True)
