"""OBJ/MTL, PLY, STL loader tests against generated fixtures."""

import struct

import numpy as np
import pytest

from mrt.loaders import (load_obj, FnObjBuilder, SimpleTexturedBuilder,
                         load_ply, load_stl_binary)


class TestObj:
    OBJ = """\
# comment
mtllib test.mtl
o main
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 1
vn 0 0 1
vt 0 0
vt 1 0
vt 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1
g skipme
f 1/1/1 2/2/1 4/1/1
g keep
f 2/2/1 3/3/1 4/1/1
"""
    MTL = """\
newmtl red
Kd 0.9 0.1 0.2
newmtl tex
map_Kd checker.png
"""

    def _write(self, tmp_path, with_png=False):
        (tmp_path / "test.obj").write_text(self.OBJ)
        (tmp_path / "test.mtl").write_text(self.MTL)
        if with_png:
            from mrt.runtime.io import encode_png
            img = np.zeros((2, 2, 4), np.uint8)
            img[..., 0] = [[255, 0], [0, 255]]
            img[..., 3] = 255
            (tmp_path / "checker.png").write_bytes(encode_png(img))
        return str(tmp_path / "test.obj")

    def test_fn_builder_faces_and_groups(self, tmp_path):
        path = self._write(tmp_path)
        faces = load_obj(path, FnObjBuilder(
            face_fn=lambda a, b, c: (a[0], b[0], c[0]),
            group_filter=lambda g: g != "skipme"))
        assert len(faces) == 2  # the skipme group's face dropped
        np.testing.assert_allclose(faces[0],
                                   [(0, 0, 0), (1, 0, 0), (0, 1, 0)])

    def test_simple_textured_builder(self, tmp_path):
        from mrt.materials.table import MaterialBuilder
        from mrt.textures import AtlasBuilder

        path = self._write(tmp_path, with_png=True)
        mats, atlas = MaterialBuilder(), AtlasBuilder()
        b = SimpleTexturedBuilder(mats, atlas, filtered_groups={"skipme"})
        load_obj(path, b)
        tris = b.finish()
        assert tris.count == 2
        # UV v-flip (obj_loader.rs:274-276): vt 0 0 -> (0, 1).
        np.testing.assert_allclose(np.asarray(tris.uva)[0], [0.0, 1.0])
        # Material rows exist for both mtl entries.
        table = mats.build()
        assert table.count >= 2

    def test_v_slash_slash_n_form(self, tmp_path):
        obj = "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvt 0.5 0.25\nf 1//1 2//1 3//1\n"
        p = tmp_path / "n.obj"
        p.write_text(obj)
        faces = load_obj(str(p), FnObjBuilder(
            face_fn=lambda a, b, c: (a, b, c)))
        # Reference quirk: v//n uses uvs[0] for every corner.
        assert faces[0][0][2] == (0.5, 0.25)
        assert faces[0][1][2] == (0.5, 0.25)

    def test_malformed_vertex_raises(self, tmp_path):
        p = tmp_path / "bad.obj"
        p.write_text("v 1 nope 3\n")
        with pytest.raises(ValueError, match="vertex"):
            load_obj(str(p), FnObjBuilder())


_PLY_VERTS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                      np.float32)
_PLY_FACES = np.array([[0, 1, 2], [1, 3, 2]], np.int64)


def _ascii_ply():
    lines = ["ply", "format ascii 1.0", "comment generated",
             "element vertex 4",
             "property float x", "property float y", "property float z",
             "property float confidence",  # unknown prop: skipped
             "element face 2",
             "property list uchar int vertex_indices",
             "end_header"]
    for v in _PLY_VERTS:
        lines.append(f"{v[0]} {v[1]} {v[2]} 0.5")
    for f in _PLY_FACES:
        lines.append(f"3 {f[0]} {f[1]} {f[2]}")
    return ("\n".join(lines) + "\n").encode()


def _binary_ply(endian="<"):
    fmt_name = ("binary_little_endian" if endian == "<"
                else "binary_big_endian")
    header = ("ply\n"
              f"format {fmt_name} 1.0\n"
              "element vertex 4\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar quality\n"
              "element face 2\n"
              "property list uchar int vertex_indices\n"
              "end_header\n").encode()
    body = b""
    for v in _PLY_VERTS:
        body += struct.pack(endian + "fffB", v[0], v[1], v[2], 7)
    for f in _PLY_FACES:
        body += struct.pack(endian + "Biii", 3, *f)
    return header + body


class TestPly:
    def test_ascii(self, tmp_path):
        p = tmp_path / "a.ply"
        p.write_bytes(_ascii_ply())
        verts, faces = load_ply(str(p))
        np.testing.assert_allclose(verts, _PLY_VERTS)
        np.testing.assert_array_equal(faces, _PLY_FACES)

    @pytest.mark.parametrize("endian", ["<", ">"])
    def test_binary(self, tmp_path, endian):
        p = tmp_path / "b.ply"
        p.write_bytes(_binary_ply(endian))
        verts, faces = load_ply(str(p))
        np.testing.assert_allclose(verts, _PLY_VERTS)
        np.testing.assert_array_equal(faces, _PLY_FACES)

    def test_callbacks_stream(self, tmp_path):
        p = tmp_path / "a.ply"
        p.write_bytes(_ascii_ply())
        got_v, got_f = [], []
        load_ply(str(p), vertex_fn=lambda x, y, z: got_v.append((x, y, z)),
                 face_fn=lambda a, b, c: got_f.append((a, b, c)))
        assert len(got_v) == 4 and len(got_f) == 2

    def test_reference_cube_asset(self, tmp_path):
        # The reference ships cube.ply (used by cornell/menger); write
        # the same cube from the procedural builder as an ASCII PLY.
        from mrt.geometry.shapes import cube

        soup = cube(size=2.0)
        va = np.asarray(soup.va)
        corners = np.stack([va, va + np.asarray(soup.e_ab),
                            va + np.asarray(soup.e_ac)], axis=1)
        uniq, idx = np.unique(corners.reshape(-1, 3).round(6), axis=0,
                              return_inverse=True)
        tri = idx.reshape(-1, 3)
        lines = ["ply", "format ascii 1.0",
                 f"element vertex {len(uniq)}", "property float x",
                 "property float y", "property float z",
                 f"element face {len(tri)}",
                 "property list uchar int vertex_indices", "end_header"]
        lines += [" ".join(f"{c:g}" for c in v) for v in uniq]
        lines += ["3 " + " ".join(map(str, f)) for f in tri]
        p = tmp_path / "cube.ply"
        p.write_text("\n".join(lines) + "\n")

        verts, faces = load_ply(str(p))
        assert verts.shape[0] >= 8 and faces.shape[0] >= 12
        # A cube spans an axis-aligned box.
        assert np.allclose(verts.min(0), verts.min()), "cube is a box"
        np.testing.assert_allclose(verts[faces], corners, atol=1e-6)

    def test_bad_magic(self, tmp_path):
        p = tmp_path / "x.ply"
        p.write_bytes(b"notply\n")
        with pytest.raises(ValueError, match="magic"):
            load_ply(str(p))


class TestStl:
    def test_binary_roundtrip(self, tmp_path):
        tris = np.array([
            [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
            [[0, 0, 1], [1, 0, 1], [0, 1, 1]],
        ], np.float32)
        body = b"H" * 80 + struct.pack("<I", 2)
        for t in tris:
            body += struct.pack("<fff", 0, 0, 1)  # normal (skipped)
            for v in t:
                body += struct.pack("<fff", *v)
            body += struct.pack("<H", 0)
        p = tmp_path / "t.stl"
        p.write_bytes(body)
        verts, faces = load_stl_binary(str(p))
        np.testing.assert_allclose(verts.reshape(2, 3, 3), tris)
        assert faces.shape == (2, 3)

    def test_truncated_raises(self, tmp_path):
        p = tmp_path / "bad.stl"
        p.write_bytes(b"H" * 80 + struct.pack("<I", 5) + b"xx")
        with pytest.raises(ValueError, match="truncated"):
            load_stl_binary(str(p))
