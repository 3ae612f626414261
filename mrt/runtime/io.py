"""PNG export/import (stdlib zlib, no imaging library).

The reference exports via the `image` crate with a vertical flip because
its buffers are bottom-up (reference: src/main.rs:760-783); film rows here
are also bottom-up so `save_png` flips the same way.

The encoder writes 8-bit RGB or RGBA, one IDAT chunk, no row filters.
The decoder reads 8-bit, non-interlaced RGB and RGBA with any of the
five row filters, and rejects every other PNG with a ValueError.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 4: 6}      # channels -> PNG colour type
_CHANNELS = {2: 3, 6: 4}         # PNG colour type -> channels


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels, level=6):
    """(H,W,3|4) uint8 top-down rows -> PNG file bytes."""
    px = np.ascontiguousarray(pixels, dtype=np.uint8)
    if px.ndim != 3 or px.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"expected (H, W, 3|4) pixels, got {px.shape}")
    h, w, c = px.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)   # filter byte 0 per row
    raw[:, 1:] = px.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def _unfilter(data, h, w, c):
    stride = w * c
    rows = np.frombuffer(data, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, f = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = f
        elif kind == 1:      # Sub: running sum per channel
            cur = np.cumsum(f.reshape(w, c), axis=0).reshape(-1) & 0xFF
        elif kind == 2:      # Up
            cur = (f + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: serial along the row
            cur = f.copy()
            for x in range(0, stride, c):
                up = prev[x:x + c]
                left = cur[x - c:x] if x else np.zeros(c, np.int32)
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    ul = prev[x - c:x] if x else np.zeros(c, np.int32)
                    p = left + up - ul
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - ul))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, ul))
                cur[x:x + c] = (cur[x:x + c] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, c)


def decode_png(data):
    """PNG file bytes -> (H,W,3|4) uint8 top-down rows."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}): only 8-bit non-interlaced RGB and "
            "RGBA are read")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w,
                     _CHANNELS[ctype])


def save_png(path, rgb_bytes):
    """Write (H,W,3) uint8 bottom-up rows to a top-down PNG file
    (reference: Image::dump, main.rs:760-783)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(rgb_bytes)[::-1]))


def load_png(path):
    """Load a PNG to normalized float32 RGBA (reference:
    Texture::load_png, texture.rs:30-69).  Returns (H,W,4) in [0,1],
    top-down rows as stored in the file."""
    with open(path, "rb") as f:
        px = decode_png(f.read())
    if px.shape[2] == 3:
        px = np.concatenate(
            [px, np.full(px.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return px.astype(np.float32) / 255.0
