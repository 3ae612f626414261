"""The stdlib PNG encoder/decoder (mrt/runtime/io.py)."""

import io
import struct
import zlib

import numpy as np
import pytest

from mrt.runtime.io import (decode_png, encode_png, load_png, save_png,
                            _chunk, _SIGNATURE)


@pytest.mark.parametrize("channels", [3, 4])
def test_round_trip(channels):
    px = np.random.default_rng(channels).integers(
        0, 256, (37, 53, channels), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(px)), px)


def _filtered_png(px, kinds):
    """Encode with the given row filter per row (PNG spec §9)."""
    h, w, c = px.shape
    rows = px.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        k = kinds[y % len(kinds)]
        if k == 0:
            pred = 0
        elif k == 1:
            pred = left
        elif k == 2:
            pred = prev
        elif k == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(bytes([k]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(out)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_decodes_every_row_filter(channels):
    px = np.random.default_rng(7).integers(0, 256, (10, 9, channels),
                                           dtype=np.uint8)
    data = _filtered_png(px, kinds=[0, 1, 2, 3, 4])
    np.testing.assert_array_equal(decode_png(data), px)


def test_matches_an_independent_codec():
    Image = pytest.importorskip("PIL.Image")
    px = np.kron(np.random.default_rng(1).integers(
        0, 256, (12, 10, 4), dtype=np.uint8), np.ones((3, 3, 1), np.uint8))
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(decode_png(buf.getvalue()), px)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(encode_png(px)))), px)


def test_save_flips_and_load_adds_alpha(tmp_path):
    rgb = np.zeros((4, 3, 3), np.uint8)
    rgb[0] = 200                        # bottom row of the film
    path = tmp_path / "sub" / "f.png"
    save_png(str(path), rgb)
    img = load_png(str(path))
    assert img.shape == (4, 3, 4) and img.dtype == np.float32
    np.testing.assert_allclose(img[-1, :, :3], 200 / 255.0)  # top-down
    np.testing.assert_allclose(img[..., 3], 1.0)


@pytest.mark.parametrize("depth,ctype,interlace", [
    (16, 6, 0),      # 16-bit RGBA
    (8, 3, 0),       # palette
    (8, 2, 1),       # Adam7 interlaced RGB
    (8, 0, 0),       # greyscale
])
def test_rejects_unsupported(depth, ctype, interlace):
    ihdr = struct.pack(">IIBBBBB", 2, 2, depth, ctype, 0, 0, interlace)
    data = (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"\0" * 64))
            + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(data)


def test_rejects_non_png():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a....")
