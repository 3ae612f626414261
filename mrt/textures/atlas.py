"""Texture atlas: all surfaces in one flat buffer, sampled by gathers.

The reference's `Surface` trait family (reference: src/texture.rs) is a
tree of trait objects sampled per-ray.  Here every texture's pixels
live in one flat (P,4) array; a texture id indexes SoA row metadata
(offset/size/wrap/kind) and `sample(ids, uv)` bilinearly samples a whole
wavefront with gathers.

Combinators are rows too, resolved branch-free with ONE level of
indirection (their children must be RAW rows — true of every reference
composition, e.g. eve.rs:342-364):
  RAW       pixels, bilinear + wrap       (texture.rs:126-148)
  BLEND     Lighten/Darken/Add/Sub of two children (texture.rs:250-334)
  YCBCR     luma + chroma children -> BT.709 YUV -> clamp -> gamma 2.2
                                                  (texture.rs:196-248)
  FALLBACK  alpha-composite child over a solid     (texture.rs:336-360)

Bilinear matches the reference exactly: uv wrapped first, scaled by
(size-1), floor/ceil corners, x-then-y lerp (texture.rs:134-148).
Wrap modes Repeat (negative-coord handling) and Clamp per
texture.rs:277-300; Mirror — unimplemented!() in the reference — is
implemented here as a proper mirror.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..utils import struct

# Row kinds
RAW = 0
BLEND = 1
YCBCR = 2
FALLBACK = 3

# Wrap modes (texture.rs:270-275)
REPEAT = 0
CLAMP = 1
MIRROR = 2

# Blend modes (texture.rs:253-259)
LIGHTEN = 0
DARKEN = 1
ADDITION = 2
SUBTRACTION = 3

# BT.709 constants (texture.rs:196-205)
_KR, _KG, _KB = 0.2126, 0.7152, 0.0722


def _host_resample(img, h, w):
    """Reference-style bilinear resample to (h,w) on host
    (texture.rs:134-148 scaling by size-1)."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img
    y = np.linspace(0.0, 1.0, h) * (ih - 1)
    x = np.linspace(0.0, 1.0, w) * (iw - 1)
    y0 = np.floor(y).astype(int)
    y1 = np.ceil(y).astype(int)
    x0 = np.floor(x).astype(int)
    x1 = np.ceil(x).astype(int)
    ty = (y - y0)[:, None, None]
    tx = (x - x0)[None, :, None]
    p0 = img[y0][:, x0] * (1 - tx) + img[y0][:, x1] * tx
    p1 = img[y1][:, x0] * (1 - tx) + img[y1][:, x1] * tx
    return p1 * ty + p0 * (1 - ty)


@struct.dataclass
class TextureAtlas:
    data: jnp.ndarray      # (P,4) all texels, concatenated row-major
    offset: jnp.ndarray    # (T,) first texel of RAW rows
    width: jnp.ndarray     # (T,)
    height: jnp.ndarray    # (T,)
    wrap: jnp.ndarray      # (T,)
    kind: jnp.ndarray      # (T,)
    left: jnp.ndarray      # (T,) child id (RAW rows: self)
    right: jnp.ndarray     # (T,) child id (RAW rows: self)
    mode: jnp.ndarray      # (T,) blend mode
    fb_color: jnp.ndarray  # (T,4) fallback solid color
    # Packed tables, so a sample reads few wide rows instead of many
    # narrow ones:
    #   qdata: (P,16) quad-packed texels [t(x,y) t(x+1,y) t(x,y+1)
    #     t(x+1,y+1)], edge-clamped.  ONE gather per bilinear sample
    #     instead of four; the clamped neighbour always carries lerp
    #     weight exactly 0, so results are bit-identical.
    #   meta: (T,12) f32-packed row metadata [offset width height wrap
    #     kind left right mode fb_color(4)]: one row read instead of
    #     ~12 separate gathers.
    # Both are None on old pytrees / oversized atlases (per-array reads).
    qdata: jnp.ndarray = None
    meta: jnp.ndarray = None
    # Static: every row is RAW (no combinators) -> sample() can skip the
    # right-child sample and the combinator selects entirely.
    all_raw: bool = struct.field(pytree_node=False, default=False)

    @property
    def count(self):
        return self.offset.shape[0]

    def _wrap(self, w, x):
        """Reference wrap (texture.rs:277-300), vectorised."""
        neg = x < 0.0
        rep = jnp.where(neg, 1.0 - jnp.abs(x) % 1.0, x)
        rep = jnp.where(rep > 1.0, rep % 1.0, rep)
        clamp = jnp.clip(x, 0.0, 1.0)
        # Mirror: triangle wave with period 2.
        mir = 1.0 - jnp.abs((jnp.abs(x) / 2.0) % 1.0 * 2.0 - 1.0)
        return jnp.where(w == REPEAT, rep,
                         jnp.where(w == CLAMP, clamp, mir))

    def _meta_rows(self, ids):
        """(offset, width, height, wrap, kind, left, right, mode,
        fb_color) for ids — one packed lookup when available."""
        if self.meta is None:
            return (self.offset[ids], self.width[ids], self.height[ids],
                    self.wrap[ids], self.kind[ids], self.left[ids],
                    self.right[ids], self.mode[ids], self.fb_color[ids])
        m = self.meta[ids]
        i = lambda k: jnp.round(m[:, k]).astype(jnp.int32)
        return (i(0), i(1), i(2), i(3), i(4), i(5), i(6), i(7),
                m[:, 8:12])

    def _sample_raw(self, ids, uv, meta=None):
        """Bilinear sample of RAW rows (texture.rs:126-148)."""
        if meta is None:
            meta = self._meta_rows(ids)
        off, w, h, wm = meta[0], meta[1], meta[2], meta[3]

        u = self._wrap(wm, uv[..., 0])
        v = self._wrap(wm, uv[..., 1])
        x = u * (w - 1).astype(jnp.float32)
        y = v * (h - 1).astype(jnp.float32)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        tx = (x - x0.astype(jnp.float32))[..., None]
        ty = (y - y0.astype(jnp.float32))[..., None]

        if self.qdata is not None:
            q = self.qdata[off + y0 * w + x0]       # ONE gather
            t00, t10 = q[:, 0:4], q[:, 4:8]
            t01, t11 = q[:, 8:12], q[:, 12:16]
            p0 = t00 * (1.0 - tx) + t10 * tx
            p1 = t01 * (1.0 - tx) + t11 * tx
            return p1 * ty + p0 * (1.0 - ty)

        x1 = jnp.ceil(x).astype(jnp.int32)
        y1 = jnp.ceil(y).astype(jnp.int32)

        def texel(xx, yy):
            return self.data[off + yy * w + xx]

        p0 = texel(x0, y0) * (1.0 - tx) + texel(x1, y0) * tx
        p1 = texel(x0, y1) * (1.0 - tx) + texel(x1, y1) * tx
        return p1 * ty + p0 * (1.0 - ty)

    def sample(self, ids, uv, raw=False):
        """Sample any row kind for a wavefront: ids (N,), uv (N,2) ->
        (N,4) RGBA.

        raw=True asserts every id is a RAW row (static, caller-proved
        — e.g. Scene.mat_tex_raw: all material-referenced textures are
        raw, combinators only in the background).  Bit-identical to
        the general path for raw ids (kind==RAW selects `sl`, and a
        RAW row's left child is itself) but does ONE texel gather
        instead of two."""
        ids = jnp.asarray(ids)
        if self.all_raw or raw:
            # left == self for RAW rows; no combinator resolution.
            return self._sample_raw(ids, uv)
        meta = self._meta_rows(ids)
        kind, left, right = meta[4], meta[5], meta[6]
        sl = self._sample_raw(left, uv)
        sr = self._sample_raw(right, uv)

        # BLEND (texture.rs:253-259): elementwise on all 4 channels.
        mode = meta[7][..., None]
        blended = jnp.select(
            [mode == LIGHTEN, mode == DARKEN, mode == ADDITION],
            [jnp.maximum(sl, sr), jnp.minimum(sl, sr),
             jnp.minimum(sl + sr, 1.0)],
            jnp.maximum(sl - sr, 0.0))

        # YCBCR (texture.rs:228-247): left=luma, right=chroma.
        yy = sl[..., 0]
        uu = sr[..., 0] - 0.5
        vv = sr[..., 1] - 0.5
        r = yy + vv * (2.0 - 2.0 * _KR)
        g = (yy + uu * (-(_KB / _KG) * (2.0 - 2.0 * _KB))
             + vv * (-(_KR / _KG) * (2.0 - 2.0 * _KR)))
        b = yy + uu * (2.0 - 2.0 * _KB)
        ycbcr = jnp.stack([r, g, b], axis=-1)
        ycbcr = jnp.clip(ycbcr, 0.0, 1.0) ** 2.2
        ycbcr = jnp.concatenate(
            [ycbcr, jnp.ones(ycbcr.shape[:-1] + (1,), jnp.float32)],
            axis=-1)

        # FALLBACK (texture.rs:356-359): color*(1-a) + c*a, all channels.
        a = sl[..., 3:4]
        fallback = meta[8] * (1.0 - a) + sl * a

        return jnp.select(
            [kind[..., None] == RAW, kind[..., None] == BLEND,
             kind[..., None] == YCBCR],
            [sl, blended, ycbcr], fallback)


class AtlasBuilder:
    """Host-side accumulator producing a TextureAtlas."""

    def __init__(self):
        self._pixels = []   # list of flattened (H*W,4) arrays
        self._rows = []
        self._cursor = 0

    def _add_row(self, **kw):
        row = dict(offset=0, width=1, height=1, wrap=REPEAT, kind=RAW,
                   left=len(self._rows), right=len(self._rows),
                   mode=LIGHTEN, fb_color=(0, 0, 0, 0))
        row.update(kw)
        self._rows.append(row)
        return len(self._rows) - 1

    def add_raw(self, rgba, wrap=REPEAT):
        """rgba: (H,W,4) float32 in [0,1], row 0 = image top (the PNG
        storage order the reference indexes, texture.rs:115-119)."""
        rgba = np.ascontiguousarray(np.asarray(rgba, np.float32))
        if rgba.ndim != 3 or rgba.shape[2] != 4:
            raise ValueError(f"expected (H,W,4), got {rgba.shape}")
        h, w = rgba.shape[:2]
        tid = self._add_row(offset=self._cursor, width=w, height=h,
                            wrap=wrap)
        self._pixels.append(rgba.reshape(-1, 4))
        self._cursor += h * w
        return tid

    def add_png(self, path, wrap=REPEAT):
        """Normalized RGBA load (texture.rs:30-69)."""
        from ..runtime.io import load_png
        return self.add_raw(load_png(path), wrap=wrap)

    def add_solid(self, rgba):
        """1x1 solid color (texture.rs:179-194)."""
        c = np.asarray(tuple(rgba) + (1.0,) * (4 - len(tuple(rgba))),
                       np.float32)
        return self.add_raw(c.reshape(1, 1, 4))

    def _check_raw(self, tid):
        if self._rows[tid]["kind"] != RAW:
            raise ValueError("combinator children must be RAW rows")

    def add_ycbcr(self, luma, chroma):
        """luma/chroma: RAW texture ids (texture.rs:207-226)."""
        self._check_raw(luma), self._check_raw(chroma)
        return self._add_row(kind=YCBCR, left=luma, right=chroma)

    def add_blend(self, mode, left, right):
        self._check_raw(left), self._check_raw(right)
        return self._add_row(kind=BLEND, mode=mode, left=left, right=right)

    def add_fallback(self, color, inner):
        """Solid-color fallback by alpha (texture.rs:336-360)."""
        self._check_raw(inner)
        c = tuple(color) + (1.0,) * (4 - len(tuple(color)))
        return self._add_row(kind=FALLBACK, left=inner, fb_color=c)

    # -- host-side evaluation / baking ------------------------------------

    def _host_pixels(self, tid):
        """Evaluate a row to an (H,W,4) numpy array on host."""
        row = self._rows[tid]
        if row["kind"] == RAW:
            off, w, h = row["offset"], row["width"], row["height"]
            # Locate the pixel block containing this offset.
            flat = np.concatenate(self._pixels, axis=0)
            return flat[off:off + w * h].reshape(h, w, 4)
        if row["kind"] == YCBCR:
            luma = self._host_pixels(row["left"])
            chroma = self._host_pixels(row["right"])
            chroma = _host_resample(chroma, luma.shape[0], luma.shape[1])
            yy = luma[..., 0]
            uu = chroma[..., 0] - 0.5
            vv = chroma[..., 1] - 0.5
            r = yy + vv * (2.0 - 2.0 * _KR)
            g = (yy + uu * (-(_KB / _KG) * (2.0 - 2.0 * _KB))
                 + vv * (-(_KR / _KG) * (2.0 - 2.0 * _KR)))
            b = yy + uu * (2.0 - 2.0 * _KB)
            rgb = np.clip(np.stack([r, g, b], -1), 0.0, 1.0) ** 2.2
            return np.concatenate(
                [rgb, np.ones(rgb.shape[:-1] + (1,), np.float32)], -1)
        raise NotImplementedError(f"host eval of kind {row['kind']}")

    def bake_blend(self, mode, left, right, wrap=REPEAT):
        """Host-bake a blend of two rows (any host-evaluable kind) into a
        RAW row at the finer resolution.  Used where the reference nests
        combinators two deep (eve.rs:353: Blend(stars, YCbCr(nebula)))
        — exact at the baked texel grid, bilinear between texels."""
        lp = self._host_pixels(left)
        rp = self._host_pixels(right)
        h = max(lp.shape[0], rp.shape[0])
        w = max(lp.shape[1], rp.shape[1])
        lp = _host_resample(lp, h, w)
        rp = _host_resample(rp, h, w)
        if mode == LIGHTEN:
            out = np.maximum(lp, rp)
        elif mode == DARKEN:
            out = np.minimum(lp, rp)
        elif mode == ADDITION:
            out = np.minimum(lp + rp, 1.0)
        else:
            out = np.maximum(lp - rp, 0.0)
        return self.add_raw(out, wrap=wrap)

    def bake_addition(self, left, right, wrap=REPEAT):
        return self.bake_blend(ADDITION, left, right, wrap=wrap)

    # Quad-packed texels are 4x the atlas memory; beyond this texel
    # count fall back to the 4-gather bilinear path.
    QUAD_TEXEL_LIMIT = 4 << 20   # 4M texels = 256 MB packed

    def build(self) -> TextureAtlas:
        if not self._pixels:
            self.add_solid((1.0, 1.0, 1.0, 1.0))
        rows = self._rows
        g = lambda k, dt: jnp.asarray(np.array([r[k] for r in rows], dt))
        data = np.concatenate(self._pixels, axis=0)

        def quads(r):
            off, w, h = r["offset"], r["width"], r["height"]
            img = data[off:off + h * w].reshape(h, w, 4)
            xp = np.minimum(np.arange(w) + 1, w - 1)
            yp = np.minimum(np.arange(h) + 1, h - 1)
            return np.concatenate(
                [img, img[:, xp], img[yp], img[yp][:, xp]],
                axis=-1).reshape(-1, 16)

        qdata = None
        if data.shape[0] <= self.QUAD_TEXEL_LIMIT:
            q = np.zeros((data.shape[0], 16), np.float32)
            for r in rows:
                if r["kind"] != RAW:
                    continue
                off, w, h = r["offset"], r["width"], r["height"]
                q[off:off + h * w] = quads(r)
            qdata = jnp.asarray(q)

        meta = None
        if data.shape[0] < (1 << 24):   # offsets must be f32-exact ints
            meta = jnp.asarray(np.concatenate([
                np.array([[r["offset"], r["width"], r["height"],
                           r["wrap"], r["kind"], r["left"], r["right"],
                           r["mode"]] for r in rows], np.float32),
                np.array([r["fb_color"] for r in rows], np.float32),
            ], axis=-1))

        return TextureAtlas(
            data=jnp.asarray(data),
            offset=g("offset", np.int32),
            width=g("width", np.int32),
            height=g("height", np.int32),
            wrap=g("wrap", np.int32),
            kind=g("kind", np.int32),
            left=g("left", np.int32),
            right=g("right", np.int32),
            mode=g("mode", np.int32),
            fb_color=g("fb_color", np.float32),
            qdata=qdata,
            meta=meta,
            all_raw=all(r["kind"] == RAW for r in rows),
        )
