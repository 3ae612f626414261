"""Texture atlas tests vs a scalar port of the reference sampling."""

import numpy as np
import jax.numpy as jnp

from mrt.textures import (AtlasBuilder, REPEAT, CLAMP, MIRROR, LIGHTEN, DARKEN,
                          ADDITION, SUBTRACTION)


def _ref_wrap_repeat(x):
    # texture.rs:281-291
    if x < 0.0:
        x = 1.0 - (abs(x) % 1.0)
    if x > 1.0:
        x = x % 1.0
    return x


def _ref_bilinear(img, u, v, wrap="repeat"):
    # texture.rs:126-148
    h, w = img.shape[:2]
    if wrap == "repeat":
        u, v = _ref_wrap_repeat(u), _ref_wrap_repeat(v)
    else:
        u, v = min(max(u, 0.0), 1.0), min(max(v, 0.0), 1.0)
    x = u * (w - 1)
    y = v * (h - 1)
    x0, x1 = int(np.floor(x)), int(np.ceil(x))
    y0, y1 = int(np.floor(y)), int(np.ceil(y))
    t = x - x0
    p0 = img[y0, x0] * (1 - t) + img[y0, x1] * t
    p1 = img[y1, x0] * (1 - t) + img[y1, x1] * t
    t = y - y0
    return p1 * t + p0 * (1 - t)


class TestBilinear:
    def test_matches_reference_sampling(self, rng):
        img = rng.random((7, 5, 4)).astype(np.float32)
        b = AtlasBuilder()
        tid = b.add_raw(img, wrap=REPEAT)
        atlas = b.build()

        uvs = rng.uniform(-2, 3, (64, 2)).astype(np.float32)
        out = np.asarray(atlas.sample(
            jnp.full((64,), tid, jnp.int32), jnp.asarray(uvs)))
        for k in range(64):
            expect = _ref_bilinear(img, uvs[k, 0], uvs[k, 1])
            np.testing.assert_allclose(out[k], expect, rtol=1e-4,
                                       atol=1e-5, err_msg=f"uv={uvs[k]}")

    def test_clamp(self, rng):
        img = rng.random((4, 4, 4)).astype(np.float32)
        b = AtlasBuilder()
        tid = b.add_raw(img, wrap=CLAMP)
        atlas = b.build()
        uvs = np.array([[-0.5, 0.5], [1.5, 0.5], [0.5, -2.0], [0.5, 9.0]],
                       np.float32)
        out = np.asarray(atlas.sample(jnp.full((4,), tid, jnp.int32),
                                      jnp.asarray(uvs)))
        for k in range(4):
            expect = _ref_bilinear(img, uvs[k, 0], uvs[k, 1], wrap="clamp")
            np.testing.assert_allclose(out[k], expect, rtol=1e-5)

    def test_texel_centers_exact(self, rng):
        img = rng.random((3, 3, 4)).astype(np.float32)
        b = AtlasBuilder()
        tid = b.add_raw(img)
        atlas = b.build()
        # uv hitting exact texel coordinates (scale by size-1).
        uv = jnp.asarray([[0.0, 0.0], [1.0, 1.0], [0.5, 0.5]])
        out = np.asarray(atlas.sample(jnp.full((3,), tid, jnp.int32), uv))
        np.testing.assert_allclose(out[0], img[0, 0], rtol=1e-6)
        np.testing.assert_allclose(out[1], img[2, 2], rtol=1e-6)
        np.testing.assert_allclose(out[2], img[1, 1], rtol=1e-6)

    def test_solid_color(self):
        b = AtlasBuilder()
        tid = b.add_solid((0.2, 0.4, 0.6))
        atlas = b.build()
        out = np.asarray(atlas.sample(jnp.asarray([tid]),
                                      jnp.asarray([[0.7, 0.3]])))
        np.testing.assert_allclose(out[0], [0.2, 0.4, 0.6, 1.0], rtol=1e-6)


class TestCombinators:
    def test_blend_modes(self, rng):
        l_img = rng.random((2, 2, 4)).astype(np.float32)
        r_img = rng.random((2, 2, 4)).astype(np.float32)
        b = AtlasBuilder()
        left = b.add_raw(l_img)
        right = b.add_raw(r_img)
        ids = [b.add_blend(m, left, right)
               for m in (LIGHTEN, DARKEN, ADDITION, SUBTRACTION)]
        atlas = b.build()
        uv = jnp.asarray([[0.0, 0.0]] * 4)
        out = np.asarray(atlas.sample(jnp.asarray(ids), uv))
        lv, rv = l_img[0, 0], r_img[0, 0]
        np.testing.assert_allclose(out[0], np.maximum(lv, rv), rtol=1e-5)
        np.testing.assert_allclose(out[1], np.minimum(lv, rv), rtol=1e-5)
        np.testing.assert_allclose(out[2], np.minimum(lv + rv, 1.0),
                                   rtol=1e-5)
        np.testing.assert_allclose(out[3], np.maximum(lv - rv, 0.0),
                                   rtol=1e-5, atol=1e-6)

    def test_ycbcr(self):
        # Grey luma + neutral chroma (0.5, 0.5) -> grey^2.2.
        b = AtlasBuilder()
        luma = b.add_raw(np.full((1, 1, 4), 0.5, np.float32))
        chroma = b.add_raw(np.full((1, 1, 4), 0.5, np.float32))
        tid = b.add_ycbcr(luma, chroma)
        atlas = b.build()
        out = np.asarray(atlas.sample(jnp.asarray([tid]),
                                      jnp.asarray([[0.0, 0.0]])))
        np.testing.assert_allclose(out[0, :3], 0.5 ** 2.2, rtol=1e-4)
        assert out[0, 3] == 1.0

    def test_ycbcr_primaries(self):
        # Full red in YUV (BT.709): y=Kr, u=-0.5*Kb'/..., just verify a
        # known point: v=+0.5 with y=Kr gives r ~= Kr + 0.5*(2-2Kr).
        kr = 0.2126
        b = AtlasBuilder()
        luma = b.add_raw(np.full((1, 1, 4), kr, np.float32))
        chroma_px = np.zeros((1, 1, 4), np.float32)
        chroma_px[..., 0] = 0.5        # u = 0
        chroma_px[..., 1] = 1.0        # v = +0.5
        chroma = b.add_raw(chroma_px)
        tid = b.add_ycbcr(luma, chroma)
        atlas = b.build()
        out = np.asarray(atlas.sample(jnp.asarray([tid]),
                                      jnp.asarray([[0.0, 0.0]])))
        expect_r = min(kr + 0.5 * (2 - 2 * kr), 1.0) ** 2.2
        np.testing.assert_allclose(out[0, 0], expect_r, rtol=1e-4)

    def test_fallback(self):
        b = AtlasBuilder()
        px = np.zeros((1, 1, 4), np.float32)
        px[..., :] = [0.8, 0.2, 0.0, 0.25]
        inner = b.add_raw(px)
        tid = b.add_fallback((0.0, 0.0, 1.0, 1.0), inner)
        atlas = b.build()
        out = np.asarray(atlas.sample(jnp.asarray([tid]),
                                      jnp.asarray([[0.0, 0.0]])))
        expect = (np.array([0, 0, 1, 1.0]) * 0.75
                  + np.array([0.8, 0.2, 0.0, 0.25]) * 0.25)
        np.testing.assert_allclose(out[0], expect, rtol=1e-5)


class TestMaterialTextures:
    def test_lambertian_textured_albedo(self):
        from mrt.geometry.hit import Hits
        from mrt.geometry.scene import Scene
        from mrt.materials import shade
        from mrt.materials.table import MaterialBuilder
        from mrt.materials.background import SkyBackground
        from mrt.math.rng import Sampler

        b = AtlasBuilder()
        px = np.zeros((1, 1, 4), np.float32)
        px[..., :] = [0.9, 0.1, 0.3, 1.0]
        tid = b.add_raw(px)
        mats = MaterialBuilder()
        m = mats.lambertian(tex=tid)
        scene = Scene(materials=mats.build(),
                      background=SkyBackground.create(), atlas=b.build())
        n = 4
        hits = Hits(
            t=jnp.ones((n,)), point=jnp.zeros((n, 3)),
            normal=jnp.zeros((n, 3)).at[:, 1].set(1.0),
            front_face=jnp.ones((n,), bool), uv=jnp.zeros((n, 2)),
            material=jnp.full((n,), m, jnp.int32),
            hit=jnp.ones((n,), bool),
            tangent=jnp.zeros((n, 3)), bitangent=jnp.zeros((n, 3)))
        atten, _, sc, _ = shade.scatter(
            scene, hits,
            jnp.zeros((n, 3)).at[:, 1].set(-1.0),
            Sampler(0, jnp.arange(n, dtype=jnp.uint32)))
        np.testing.assert_allclose(np.asarray(atten),
                                   [[0.9, 0.1, 0.3]] * n, rtol=1e-5)


class TestMirrorWrap:
    def test_mirror_triangle_wave(self, rng):
        # Mirror is unimplemented!() in the reference (texture.rs:279);
        # ours implements the proper triangle wave.
        from mrt.textures import MIRROR
        img = rng.random((1, 5, 4)).astype(np.float32)
        b = AtlasBuilder()
        tid = b.add_raw(img, wrap=MIRROR)
        atlas = b.build()
        ids = jnp.full((3,), tid, jnp.int32)
        uv = jnp.asarray([[0.25, 0.0], [-0.25, 0.0], [1.75, 0.0]])
        out = np.asarray(atlas.sample(ids, uv))
        # mirror(-0.25) == 0.25; mirror(1.75) == 0.25.
        np.testing.assert_allclose(out[1], out[0], rtol=1e-5)
        np.testing.assert_allclose(out[2], out[0], rtol=1e-5)


class TestFastPathsBitIdentical:
    """The quad-packed texel table (qdata), the packed row metadata
    (meta) and the all_raw shortcut are pure performance reshapes of the
    same sampling; each must be bit-identical to the gather fallback."""

    def _mixed_atlas(self, rng):
        b = AtlasBuilder()
        a = b.add_raw(rng.random((7, 5, 4)).astype(np.float32),
                      wrap=REPEAT)
        c = b.add_raw(rng.random((4, 9, 4)).astype(np.float32),
                      wrap=CLAMP)
        m = b.add_raw(rng.random((3, 3, 4)).astype(np.float32),
                      wrap=MIRROR)
        rows = [a, c, m,
                b.add_blend(LIGHTEN, a, c),
                b.add_blend(SUBTRACTION, c, m),
                b.add_ycbcr(a, c),
                b.add_fallback((0.2, 0.4, 0.6, 1.0), m)]
        return b.build(), rows

    def test_qdata_meta_match_gather(self, rng):
        atlas, rows = self._mixed_atlas(rng)
        assert atlas.qdata is not None and atlas.meta is not None
        slow = atlas.replace(qdata=None, meta=None)
        n = 256
        ids = jnp.asarray(rng.integers(0, len(rows), n), jnp.int32)
        uv = jnp.asarray(rng.uniform(-2, 3, (n, 2)).astype(np.float32))
        fast = np.asarray(atlas.sample(ids, uv))
        ref = np.asarray(slow.sample(ids, uv))
        np.testing.assert_array_equal(fast, ref)

    def test_all_raw_shortcut_matches(self, rng):
        b = AtlasBuilder()
        t0 = b.add_raw(rng.random((6, 6, 4)).astype(np.float32))
        t1 = b.add_raw(rng.random((2, 8, 4)).astype(np.float32),
                       wrap=CLAMP)
        atlas = b.build()
        assert atlas.all_raw
        general = atlas.replace(all_raw=False)
        n = 128
        ids = jnp.asarray(rng.integers(0, 2, n), jnp.int32)
        uv = jnp.asarray(rng.uniform(-1, 2, (n, 2)).astype(np.float32))
        np.testing.assert_array_equal(np.asarray(atlas.sample(ids, uv)),
                                      np.asarray(general.sample(ids, uv)))
