"""World-flattened single-level TLAS path vs the two-level traversal.

The flat path (instance.MeshRegistry._build_flat) pre-transforms every
instance's triangles to world space under one BVH so small instanced
scenes ride the single-level mesh kernel.  Unlike the brute path it is
NOT bit-exact vs the two-level traversal — intersecting a world-space
triangle is different arithmetic from warping the ray into object
space (the reference's scheme, geom.rs:404-414) — so winners agree to
ulp-level tolerances, with the same semantics: unit world normals,
forward-linear tangent frames, baked material overrides.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mrt.geometry.instance import (MeshRegistry, intersect_tlas,
                                   wants_flat)
from mrt.geometry.bvh import intersect_bvh
from mrt.geometry.shapes import cube, sphere_mesh


def _fleet_tlas(rng, ni=4, spacing=3.0):
    """Non-overlapping instance grid: near-coincident surfaces would
    make winner flips (legitimate under ulp t differences) flaky."""
    reg = MeshRegistry()
    m1 = reg.add_mesh(cube(size=1.0, material=1))
    m2 = reg.add_mesh(sphere_mesh(radius=0.6, lat=6, lon=8, material=2))
    for i in range(ni):
        for j in range(ni):
            mid = m1 if (i + j) % 2 == 0 else m2
            reg.add_instance(mid, translation=(i * spacing, 0.0,
                                               j * spacing),
                             rotation=(0.0, 0.1 * i, 0.05 * j),
                             scale=1.0 + 0.2 * j,
                             material=7 if (i + j) % 3 == 0 else None)
    return reg.build()


def _flat_hits(tlas, o, d, t_min, t_max):
    assert tlas.flat_tris is not None
    return intersect_bvh(tlas.flat_tris, tlas.flat_bvh, o, d, t_min,
                         t_max)


def _assert_hits_close(ha, hb, atol=1e-4):
    """ha = two-level reference, hb = flat.  Rays whose winner flipped
    on an ulp-level near-tie are excluded (must be rare)."""
    ma, mb = np.asarray(ha.hit), np.asarray(hb.hit)
    same = ma == mb
    assert same.mean() > 0.995, "hit masks diverge beyond near-ties"
    m = ma & mb
    ta, tb = np.asarray(ha.t)[m], np.asarray(hb.t)[m]
    close = np.abs(ta - tb) <= atol + 1e-4 * np.abs(ta)
    assert close.mean() > 0.995, "t diverges beyond near-ties"
    m2 = m.copy()
    m2[m] = close
    for field, tol in (("t", atol), ("point", atol), ("normal", 1e-3),
                       ("uv", 1e-3), ("prim_area", 1e-2),
                       ("tangent", 1e-3), ("bitangent", 1e-3)):
        a = np.asarray(getattr(ha, field))[m2]
        b = np.asarray(getattr(hb, field))[m2]
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=tol,
                                   err_msg=field)
    np.testing.assert_array_equal(np.asarray(ha.material)[m2],
                                  np.asarray(hb.material)[m2])
    np.testing.assert_array_equal(np.asarray(ha.front_face)[m2],
                                  np.asarray(hb.front_face)[m2])


_PARTS_RENDER_CHECK = """
import os
os.environ["MRT_FLAT_SPLIT"] = "96"
import numpy as np
from mrt.runtime.render import render
from mrt.geometry.scene import SceneBuilder
from mrt.materials.table import MaterialBuilder
from mrt.materials.background import SkyBackground
from mrt.geometry.shapes import cube, sphere_mesh
from mrt.core.camera import Camera

b = MaterialBuilder()
red = b.lambertian((0.7, 0.2, 0.2))
metal = b.metal(0.1, (0.8, 0.8, 0.9))
sb = SceneBuilder(b, SkyBackground.create())
mc = sb.add_mesh(cube(size=1.0, material=red))
ms = sb.add_mesh(sphere_mesh(radius=0.5, lat=5, lon=6, material=metal))
for i in range(4):
    sb.add_instance(mc, translation=(i * 2.0 - 3.0, 0, -3))
    sb.add_instance(ms, translation=(i * 2.0 - 3.0, 1.3, -3))
scene = sb.build()
assert scene.tlas.flat_parts is not None
assert len(scene.tlas.flat_parts) >= 3
camera = Camera.create(60.0, (0, 0.5, 2.0), (0, 0.5, -3), (0, 1, 0),
                       aspect_ratio=1.0)
# Two DIFFERENT pytree shapes force two genuine traces in one
# process (an env flip alone would hit the first program in the jit
# cache): stripped -> two-level dispatch; with parts + env ->
# clustered dispatch.
scene_ref = scene.replace(tlas=scene.tlas.replace(flat_parts=None))
ref = render(scene_ref, camera, 32, 32, spp=4, max_depth=5, seed=5)
os.environ["MRT_TLAS_KERNEL"] = "flat"
flat = render(scene, camera, 32, 32, spp=4, max_depth=5, seed=5)
a = np.asarray(ref.sum) / float(ref.samples)
bb = np.asarray(flat.sum) / float(flat.samples)
assert not np.array_equal(a, bb), "cache reuse: comparison is vacuous"
assert abs(a.mean() - bb.mean()) < 3e-3, (a.mean(), bb.mean())
assert (np.abs(a - bb) < 0.2).mean() > 0.97
print("PARITY OK")
"""


# A sky-lit scene makes every pixel carry rich float radiance, so
# genuinely-different arithmetic must differ somewhere — the
# not-equal assert catches the vacuous-compare failure mode (an env
# flip alone reuses the first program from the jit cache; the
# stripped ref pytree forces a second trace).
_FLAT_RENDER_CHECK = """
import os
import numpy as np
from mrt.runtime.render import render
from mrt.geometry.scene import SceneBuilder
from mrt.materials.table import MaterialBuilder
from mrt.materials.background import SkyBackground
from mrt.geometry.shapes import cube, sphere_mesh
from mrt.core.camera import Camera

b = MaterialBuilder()
sb = SceneBuilder(b, SkyBackground.create())
mc = sb.add_mesh(cube(size=1.0, material=b.lambertian((0.7, 0.2, 0.2))))
ms = sb.add_mesh(sphere_mesh(radius=0.5, lat=5, lon=6,
                             material=b.metal(0.1, (0.8, 0.8, 0.9))))
for i in range(3):
    sb.add_instance(mc, translation=(i * 2.0 - 2.0, 0, -3),
                    rotation=(0.0, 0.07 * i, 0.0))
    sb.add_instance(ms, translation=(i * 2.0 - 2.0, 1.3, -3))
scene = sb.build()
assert scene.tlas.flat_tris is not None
camera = Camera.create(60.0, (0, 0.5, 2.0), (0, 0.5, -3), (0, 1, 0),
                       aspect_ratio=1.0)
scene_ref = scene.replace(tlas=scene.tlas.replace(
    flat_tris=None, flat_bvh=None))
ref = render(scene_ref, camera, 32, 32, spp=8, max_depth=6, seed=5)
os.environ["MRT_TLAS_KERNEL"] = "flat"
flat = render(scene, camera, 32, 32, spp=8, max_depth=6, seed=5)
a = np.asarray(ref.sum) / float(ref.samples)
bb = np.asarray(flat.sum) / float(flat.samples)
assert not np.array_equal(a, bb), "cache reuse: vacuous compare"
assert abs(a.mean() - bb.mean()) < 2e-3, (a.mean(), bb.mean())
assert (np.abs(a - bb) < 0.15).mean() > 0.98
print("PARITY OK")
"""


class TestTlasFlat:
    def test_matches_two_level(self, rng):
        tlas = _fleet_tlas(rng)
        nr = 2000
        o = jnp.asarray(rng.uniform(-3, 12, (nr, 3)).astype(np.float32))
        # Aim at a random point near an instance so the workload is
        # dense despite the non-overlapping spacing.
        targets = rng.uniform(-1, 10, (nr, 3)).astype(np.float32)
        targets[:, 1] = rng.uniform(-1, 1, nr)
        d = jnp.asarray(targets) - o
        hx = intersect_tlas(tlas, o, d, 1e-3, jnp.inf)
        hf = _flat_hits(tlas, o, d, 1e-3, jnp.inf)
        assert np.asarray(hx.hit).mean() > 0.2
        _assert_hits_close(hx, hf)

    def test_unit_normals(self, rng):
        """Flat path must match the instanced normalise-after-linear
        semantics (geom.rs:412), not the plain-triangle unnormalised
        smooth normal (geom.rs:552)."""
        tlas = _fleet_tlas(rng, ni=2)
        assert tlas.flat_tris.unit_normal
        nr = 512
        o = jnp.asarray(rng.uniform(-2, 5, (nr, 3)).astype(np.float32))
        d = jnp.asarray(rng.standard_normal((nr, 3)).astype(np.float32))
        hf = _flat_hits(tlas, o, d, 1e-3, jnp.inf)
        m = np.asarray(hf.hit)
        norms = np.linalg.norm(np.asarray(hf.normal)[m], axis=-1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)

    def test_override_baked(self, rng):
        """Instance material overrides are baked per world triangle
        (geom.rs:317-333)."""
        reg = MeshRegistry()
        m = reg.add_mesh(cube(size=1.0, material=2))
        reg.add_instance(m, translation=(0, 0, 0), material=9)
        reg.add_instance(m, translation=(4, 0, 0))
        tlas = reg.build()
        mats = np.asarray(tlas.flat_tris.material)
        assert set(mats.tolist()) == {9, 2}
        o = jnp.asarray([[0.0, 0.0, 5.0], [4.0, 0.0, 5.0]], jnp.float32)
        d = jnp.asarray([[0.0, 0.0, -1.0]] * 2, jnp.float32)
        hf = _flat_hits(tlas, o, d, 1e-3, jnp.inf)
        np.testing.assert_array_equal(np.asarray(hf.material), [9, 2])

    def test_nonuniform_scale_normals(self, rng):
        """Forward-linear (not inverse-transpose) normal convention
        under nonuniform scale — the reference's deliberate quirk."""
        reg = MeshRegistry()
        m = reg.add_mesh(sphere_mesh(radius=1.0, lat=8, lon=10,
                                     material=3))
        reg.add_instance(m, scale=(2.0, 1.0, 0.5),
                         rotation=(0.05, 0.1, 0.0))
        tlas = reg.build()
        nr = 512
        o = jnp.asarray(rng.uniform(-4, 4, (nr, 3)).astype(np.float32))
        d = jnp.asarray(rng.standard_normal((nr, 3)).astype(np.float32))
        hx = intersect_tlas(tlas, o, d, 1e-3, jnp.inf)
        hf = _flat_hits(tlas, o, d, 1e-3, jnp.inf)
        _assert_hits_close(hx, hf)

    def test_build_gate(self):
        """Flat arrays exist only under the world-tri ceiling."""
        reg = MeshRegistry()
        m = reg.add_mesh(sphere_mesh(radius=0.5, lat=16, lon=24,
                                     material=1))
        n_tri = int(np.asarray(
            reg._meshes[0][1].va).shape[0])
        per = max(1, MeshRegistry.FLAT_MAX_TRIS // n_tri)
        for i in range(per + 1):   # one over the ceiling
            reg.add_instance(m, translation=(i * 2.0, 0, 0))
        tlas = reg.build()
        assert tlas.flat_tris is None and tlas.flat_bvh is None

    def test_wants_flat_gate(self, rng, monkeypatch):
        """The flat path is env-forced only (MRT_TLAS_KERNEL=flat or
        =auto), and only when the flat tables were built."""
        tlas = _fleet_tlas(rng, ni=2)
        monkeypatch.delenv("MRT_TLAS_KERNEL", raising=False)
        assert not wants_flat(tlas)
        monkeypatch.setenv("MRT_TLAS_KERNEL", "auto")
        assert wants_flat(tlas)         # size gate alone
        monkeypatch.setenv("MRT_TLAS_KERNEL", "flat")
        assert wants_flat(tlas)
        monkeypatch.setenv("MRT_TLAS_KERNEL", "packet")
        assert not wants_flat(tlas)
        monkeypatch.setenv("MRT_TLAS_KERNEL", "flat")
        assert not wants_flat(tlas.replace(flat_tris=None))

    def test_eve_scene_parity(self, rng):
        from mrt.scenes import get

        scene, camera = get("eve")().generate()
        assert scene.tlas.flat_tris is not None, \
            "eve must be flatten-eligible (the whole point)"
        nr = 1024
        px = jnp.asarray(rng.uniform(0, 1, nr).astype(np.float32))
        py = jnp.asarray(rng.uniform(0, 1, nr).astype(np.float32))
        o, d = camera.rays(px, py, jnp.zeros(nr), jnp.zeros(nr))
        hx = intersect_tlas(scene.tlas, o, d, 1e-3, jnp.inf)
        hf = _flat_hits(scene.tlas, o, d, 1e-3, jnp.inf)
        assert np.asarray(hx.hit).mean() > 0.05
        _assert_hits_close(hx, hf)

    def test_lucy_builds_parts(self, monkeypatch):
        """lucy (81k world tris, 122 instances) exceeds the single-flat
        ceiling but clusters into parts under the flat size cap (built
        only when requested)."""
        from mrt.scenes import get
        from mrt.geometry.instance import _flat_fits

        monkeypatch.setenv("MRT_TLAS_KERNEL", "flat")
        scene, _ = get("lucy")().generate()
        tlas = scene.tlas
        assert tlas.flat_tris is None
        assert tlas.flat_parts is not None
        total = 0
        for p in tlas.flat_parts:
            n = int(p.tris.va.shape[0])
            total += n
            assert _flat_fits(int(p.bvh.n_nodes), n)
            # Packed ids decode to valid (instance, BLAS tri) pairs.
            packed = np.asarray(p.packed)
            inst = packed >> 20
            gtri = packed & ((1 << 20) - 1)
            assert inst.min() >= 0
            assert inst.max() < tlas.transform.shape[0]
            lo = np.asarray(tlas.tri_first)[inst]
            hi = lo + np.asarray(tlas.tri_count)[inst]
            assert ((gtri >= lo) & (gtri < hi)).all()
        assert total == int(np.asarray(tlas.tri_count).sum())

    def test_parts_match_two_level(self, rng, monkeypatch):
        from mrt.scenes import get
        from mrt.geometry.instance import intersect_tlas_flat_parts

        monkeypatch.setenv("MRT_TLAS_KERNEL", "flat")
        scene, camera = get("lucy")().generate()
        nr = 2048
        px = jnp.asarray(rng.uniform(0, 1, nr).astype(np.float32))
        py = jnp.asarray(rng.uniform(0, 1, nr).astype(np.float32))
        o, d = camera.rays(px, py, jnp.zeros(nr), jnp.zeros(nr))
        hx = intersect_tlas(scene.tlas, o, d, 1e-3, jnp.inf)
        hp = intersect_tlas_flat_parts(scene.tlas, o, d, 1e-3, jnp.inf)
        assert np.asarray(hx.hit).mean() > 0.2
        _assert_hits_close(hx, hp, atol=1e-3)

    def test_parts_full_render_parity(self):
        """End-to-end clustered render vs the two-level render, in an
        isolated subprocess: compiling the multi-part render inside a
        long-lived suite process aborts the XLA CPU client (compiler
        SIGABRT with hundreds of programs already loaded) while the
        identical program compiles fine in a fresh process."""
        import subprocess
        import sys

        r = subprocess.run(
            [sys.executable, "-c", _PARTS_RENDER_CHECK],
            capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "PARITY OK" in r.stdout

    def test_full_render_parity(self):
        """End-to-end: a flat-forced render agrees with the two-level
        render to MC-mean tolerance (trajectories may diverge at ulp
        level after the first bounce).  Isolated subprocess for the
        same reason as the parts check: late-suite fresh compiles of
        these renders segfault/abort the XLA CPU compiler in a
        long-lived process, while the identical program compiles fine
        fresh."""
        import subprocess
        import sys

        r = subprocess.run(
            [sys.executable, "-c", _FLAT_RENDER_CHECK],
            capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "PARITY OK" in r.stdout
