"""The compiled scene: flat SoA arrays + a closest-hit dispatcher.

Replaces the reference's `World { objects: Vec<Box<dyn Intersect>> }` and
its linear closest-hit loop (reference: src/world.rs:95-145).  A Scene is
a pytree of typed primitive sets; `intersect` runs each set's batched
kernel and folds results with a per-ray nearest-t select — the SPMD
analogue of the reference's `closest_so_far` shrink loop.

Primitive sets are optional (None == absent); their presence is static so
each scene shape compiles its own specialised program.

`SceneBuilder` is the host-side `World` equivalent: add spheres, meshes,
instances and volumes, then `build()` the device arrays (world.rs:109-123
add/build_bvh).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from . import spheres as sphere_mod
from .hit import Hits

T_MIN = 1e-3  # reference: world.rs:68 — intersect(ray, 0.001, inf)


@struct.dataclass
class Scene:
    materials: Any                         # materials.table.MaterialTable
    background: Any
    spheres: Optional[sphere_mod.Spheres] = None
    sphere_bvh: Optional[Any] = None       # geometry.bvh.FlatBVH
    triangles: Optional[Any] = None        # geometry.triangles.Triangles
    bvh: Optional[Any] = None              # geometry.bvh.FlatBVH
    tlas: Optional[Any] = None             # geometry.instance.TLAS
    volumes: Optional[Any] = None          # geometry.volumes.VolumeSpheres
    mesh_volumes: Any = None               # tuple[volumes.MeshVolume, ...]
    #   media bounded by arbitrary instanced meshes (geom.rs:595-660)
    voxels: Any = None                     # tuple[voxels.VoxelGrid, ...]
    #   procedural/dense cell grids walked by gather-free DDA — the
    #   wavefront representation of the reference's 3.2M-instanced-cube
    #   Menger scene (src/scenes/menger.rs:68-124)
    atlas: Optional[Any] = None            # textures.atlas.TextureAtlas
    lights: Optional[Any] = None           # materials.lights.LightTable
    #   non-None => the integrator adds next-event estimation (a
    #   different, faster-converging estimator; see materials/lights.py)
    # Static: any material row can fail an alpha test (textured
    # lambertian/metal/specular, geom.rs:567-571); enables the cutout
    # re-cast rounds below.
    needs_alpha: bool = struct.field(pytree_node=False, default=False)
    # Static: any MIX rows in the material table?  False elides the
    # iterative mix-resolution table reads in shading.  Conservative
    # default True.
    has_mix: bool = struct.field(pytree_node=False, default=True)
    # Static: every texture id referenced by a MATERIAL row (tex,
    # tex_no, tex_pmdg) is a RAW atlas row — combinators
    # (YCbCr/blend/fallback) appear only in backgrounds.  True lets
    # shading take the single-gather raw sample path (atlas.sample
    # raw=True; bit-identical).  Conservative default False.
    mat_tex_raw: bool = struct.field(pytree_node=False, default=False)

    # Cutout re-cast rounds: each round can see through one failed
    # alpha-tested surface per ray (stacked cutouts beyond this bound
    # render as opaque).
    ALPHA_ROUNDS = 3

    def world_bounds(self):
        """(bmin, bmax) of all geometry — the acceleration roots (node
        0 of each escape-index BVH is the whole tree's box).  Used to
        quantise ray origins for coherence sorting."""
        mins, maxs = [], []
        if self.tlas is not None:
            mins.append(self.tlas.t_bmin[0])
            maxs.append(self.tlas.t_bmax[0])
        if self.bvh is not None:
            mins.append(self.bvh.bmin[0])
            maxs.append(self.bvh.bmax[0])
        if self.sphere_bvh is not None:
            mins.append(self.sphere_bvh.bmin[0])
            maxs.append(self.sphere_bvh.bmax[0])
        elif self.spheres is not None:
            r = self.spheres.radius[:, None]
            mins.append(jnp.min(self.spheres.center - r, axis=0))
            maxs.append(jnp.max(self.spheres.center + r, axis=0))
        if self.voxels:
            for g in self.voxels:
                lo, hi = g.world_bounds()
                mins.append(lo)
                maxs.append(hi)
        if not mins:
            return jnp.zeros(3), jnp.ones(3)
        return (jnp.min(jnp.stack(mins), axis=0),
                jnp.max(jnp.stack(maxs), axis=0))

    def intersect(self, o, d, t_min=T_MIN, t_max=jnp.inf,
                  sampler=None, shading_aux=True) -> Hits:
        """Closest hit of each ray against every primitive set.

        o, d: (N, 3).  `sampler` feeds stochastic intersections (volume
        free-flight, geom.rs:640, and Mix alpha re-rolls); scenes with
        volumes or alpha testing require it.  shading_aux=False skips
        shading-only post-processing (normal maps) — occlusion queries
        (NEE shadow rays) don't need it.
        Returns a Hits record of length N.
        """
        hits = self._intersect_once(o, d, t_min, t_max, sampler,
                                    shading_aux=shading_aux)
        if self.needs_alpha and self.atlas is not None:
            from ..materials import shade

            # The reference skips candidates whose material fails the
            # alpha test *during* traversal (geom.rs:567-571).  The
            # wavefront equivalent: test the winner, and re-cast failed
            # rays from just past the rejected hit — identical closest
            # semantics, since nothing valid exists before the winner.
            # Each round is cond-gated on any ray actually failing: a
            # skipped round is bit-identical to a where(redo=False)
            # merge, and most steps have no cutout failures, so the
            # gate drops the steady-state traversal count from
            # 1+ALPHA_ROUNDS to ~1.  (Sampler draws trace identically
            # in both branches; unused draws cost nothing.)
            for _ in range(self.ALPHA_ROUNDS):
                keep = shade.alpha_test(self, hits.material, hits.uv,
                                        sampler)
                redo = hits.hit & ~keep

                def recast(hits, redo=redo, sampler=sampler):
                    t_min2 = jnp.where(redo, hits.t + 1e-4,
                                       jnp.full_like(hits.t, t_min))
                    again = self._intersect_once(
                        o, d, t_min2, t_max, sampler,
                        shading_aux=shading_aux)
                    return jax.tree.map(
                        lambda new, old: jnp.where(
                            redo.reshape(redo.shape
                                         + (1,) * (old.ndim - 1)),
                            new, old),
                        again, hits)

                # (The sampler's Python draw counter advances while
                # `recast` is traced — tracing happens exactly once, so
                # downstream streams are identical to the ungated code.)
                hits = jax.lax.cond(jnp.any(redo), recast,
                                    lambda h: h, hits)
        return hits

    def _intersect_once(self, o, d, t_min, t_max, sampler,
                        shading_aux=True) -> Hits:
        from . import bvh as bvh_mod

        hits = Hits.none(o.shape[0])
        if self.spheres is not None:
            if self.sphere_bvh is not None:
                hits = hits.closer_of(bvh_mod.intersect_bvh_spheres(
                    self.spheres, self.sphere_bvh, o, d, t_min, t_max))
            else:
                hits = hits.closer_of(
                    sphere_mod.intersect(self.spheres, o, d, t_min, t_max))
        if self.triangles is not None:
            from . import triangles as tri_mod  # local: avoid import cycle
            if self.bvh is not None:
                hits = hits.closer_of(bvh_mod.intersect_bvh(
                    self.triangles, self.bvh, o, d, t_min, t_max,
                    scene=self))
            else:
                hits = hits.closer_of(tri_mod.intersect_brute(
                    self.triangles, o, d, t_min, t_max, scene=self))
        if self.tlas is not None:
            from . import instance as inst_mod
            from . import tlas_brute
            if inst_mod.wants_flat(self.tlas):
                # World-flattened single-level BVH (opt-in,
                # MRT_TLAS_KERNEL=flat|auto; instance.py _build_flat):
                # winner semantics preserved, t/normal values differ
                # from two-level in ulps only.
                hits = hits.closer_of(bvh_mod.intersect_bvh(
                    self.tlas.flat_tris, self.tlas.flat_bvh, o, d,
                    t_min, t_max, scene=self))
            elif inst_mod.wants_flat_parts(self.tlas):
                hits = hits.closer_of(
                    inst_mod.intersect_tlas_flat_parts(
                        self.tlas, o, d, t_min, t_max))
            elif tlas_brute.wants_brute(self.tlas):
                # Dense instanced scan: the oracle for the traversal
                # (MRT_TLAS_KERNEL=brute).
                hits = hits.closer_of(tlas_brute.intersect_tlas_brute(
                    self.tlas, o, d, t_min, t_max))
            else:
                hits = hits.closer_of(inst_mod.intersect_tlas(
                    self.tlas, o, d, t_min, t_max, scene=self))
        if self.voxels:
            from . import voxels as vox_mod
            for g in self.voxels:
                hits = hits.closer_of(vox_mod.intersect(
                    g, o, d, t_min, t_max))
        if self.volumes is not None:
            from . import volumes as vol_mod
            if sampler is None:
                raise ValueError("scene has volumes: intersect needs a "
                                 "sampler for free-flight randomness")
            v = self.volumes.count
            u = jnp.stack([sampler.next1() for _ in range(v)], axis=-1)
            hits = hits.closer_of(vol_mod.intersect(
                self.volumes, o, d, t_min, t_max, u))
        if self.mesh_volumes:
            from . import volumes as vol_mod
            if sampler is None:
                raise ValueError("scene has volumes: intersect needs a "
                                 "sampler for free-flight randomness")
            for vol in self.mesh_volumes:
                hits = hits.closer_of(vol_mod.intersect_mesh(
                    vol, o, d, t_min, t_max, sampler.next1()))
        if self.atlas is not None and shading_aux:
            from ..materials import shade
            hits = shade.apply_normal_maps(self, hits, d)
        return hits

    def background_eval(self, d):
        return self.background.eval(d, atlas=self.atlas)

    def background_eval_masked(self, d, mask):
        """where(mask, background_eval(d), 0)."""
        return jnp.where(mask[:, None], self.background_eval(d), 0.0)


def with_atlas(scene: Scene, atlas) -> Scene:
    """Attach a texture atlas to an already-built scene, recomputing
    the atlas-dependent static flags (a bare scene.replace(atlas=...)
    would leave them at their conservative defaults and pay doubled
    texel gathers per material sample)."""
    from ..textures.atlas import RAW

    kinds = np.asarray(atlas.kind)
    ids = set()
    for col in (scene.materials.tex, scene.materials.tex_no,
                scene.materials.tex_pmdg):
        for i in np.asarray(col):
            if i >= 0:
                ids.add(int(i))
    raw = all(int(kinds[i]) == RAW for i in ids)
    return scene.replace(atlas=atlas, mat_tex_raw=raw)


def attach_lights(scene: Scene) -> Scene:
    """Opt in to next-event estimation: harvest emissive geometry into
    a light table (no-op when the scene has no lights)."""
    from ..materials.lights import collect_lights

    table = collect_lights(scene)
    return scene if table is None else scene.replace(lights=table)


class SceneBuilder:
    """Host-side accumulator mirroring the reference's World + Model
    pattern (world.rs:109-115, geom.rs:281-314)."""

    def __init__(self, materials, background, atlas=None):
        """materials: a MaterialBuilder (still open for volume mats)."""
        self._materials = materials
        self._background = background
        self._atlas = atlas
        self._sphere_rows = []
        self._registry = None
        self._tri_groups = []
        self._volumes = []
        self._mesh_volumes = []
        self._voxels = []

    def _ensure_registry(self):
        if self._registry is None:
            from .instance import MeshRegistry
            self._registry = MeshRegistry()
        return self._registry

    def add_sphere(self, center, radius, material):
        self._sphere_rows.append((tuple(center), float(radius),
                                  int(material)))

    def add_mesh(self, tris, split=None):
        """Register a mesh for instancing; returns mesh id
        (the reference's Model::new, geom.rs:281-292).  split="sah"
        opts this mesh into the binned-SAH builder (per-scene rule:
        irregular high-poly meshes; see geometry/bvh.py::build)."""
        return self._ensure_registry().add_mesh(tris, split=split)

    def add_instance(self, mesh_id, translation=(0, 0, 0),
                     rotation=(0, 0, 0), scale=(1, 1, 1), material=None):
        """Place an instance (geom.rs:312-314,344); rotation in turns."""
        return self._ensure_registry().add_instance(
            mesh_id, translation, rotation, scale, material)

    def add_model(self, tris, material=None):
        """Non-instanced mesh == identity-transform instance
        (geom.rs:317-333)."""
        mesh = self.add_mesh(tris)
        return self.add_instance(mesh, material=material)

    def add_triangles(self, tris_list):
        """Small triangle sets intersected brute-force, no BVH."""
        self._tri_groups.append(tris_list)

    def add_volume_sphere(self, center, radius, density, albedo):
        """Fog volume bounded by a sphere (geom.rs:601-608 +
        scenes/eve.rs:33-45)."""
        mat = self._materials.isotropic(tuple(albedo))
        self._volumes.append((tuple(center), float(radius),
                              -1.0 / float(density), mat))

    def add_volume_mesh(self, tris, density, albedo, translation=(0, 0, 0),
                        rotation=(0, 0, 0), scale=(1, 1, 1)):
        """Fog volume bounded by an arbitrary (instanced) mesh — the
        reference's general `Volume<I>` over a transformed Model
        (geom.rs:595-660); rotation in turns."""
        mat = self._materials.isotropic(tuple(albedo))
        from .instance import MeshRegistry
        reg = MeshRegistry()
        mesh = reg.add_mesh(tris)
        reg.add_instance(mesh, translation, rotation, scale)
        self._mesh_volumes.append((reg, -1.0 / float(density), mat))

    def add_voxel_grid(self, origin, cell, levels, material,
                       rule="menger", occupancy=None):
        """Axis-aligned grid of solid unit cells (geometry/voxels.py):
        the gather-free representation for regularly-tiled instanced
        geometry (the reference's Menger sponge, menger.rs:68-124)."""
        from .voxels import VoxelGrid
        self._voxels.append(VoxelGrid.create(
            origin, cell, levels, material, rule=rule,
            occupancy=occupancy))

    # Sphere sets at or above this size get a BVH (brute force wins for
    # small counts; traversal overhead dominates below ~tens).
    SPHERE_BVH_THRESHOLD = 64

    def build(self, nee=False) -> Scene:
        """nee=True attaches a light table (next-event estimation)."""
        import jax

        spheres = None
        sphere_bvh = None
        if self._sphere_rows:
            spheres = sphere_mod.Spheres(
                center=jnp.asarray(
                    np.array([r[0] for r in self._sphere_rows],
                             np.float32)),
                radius=jnp.asarray(
                    np.array([r[1] for r in self._sphere_rows],
                             np.float32)),
                material=jnp.asarray(
                    np.array([r[2] for r in self._sphere_rows], np.int32)))
            if spheres.count >= self.SPHERE_BVH_THRESHOLD:
                from .bvh import build_over_spheres
                sphere_bvh, spheres = build_over_spheres(spheres)

        triangles = None
        if self._tri_groups:
            triangles = jax.tree.map(
                lambda *xs: jnp.asarray(
                    np.concatenate([np.asarray(x) for x in xs], axis=0)),
                *self._tri_groups)

        tlas = None
        if self._registry is not None and self._registry._instances:
            tlas = self._registry.build()

        volumes = None
        if self._volumes:
            from .volumes import VolumeSpheres
            volumes = VolumeSpheres(
                center=jnp.asarray(
                    np.array([v[0] for v in self._volumes], np.float32)),
                radius=jnp.asarray(
                    np.array([v[1] for v in self._volumes], np.float32)),
                neg_inv_density=jnp.asarray(
                    np.array([v[2] for v in self._volumes], np.float32)),
                material=jnp.asarray(
                    np.array([v[3] for v in self._volumes], np.int32)))

        mesh_volumes = None
        if self._mesh_volumes:
            from .volumes import MeshVolume
            mesh_volumes = tuple(
                MeshVolume(tlas=reg.build(),
                           neg_inv_density=jnp.float32(nid),
                           material=jnp.int32(mat))
                for reg, nid, mat in self._mesh_volumes)

        mat_tex_raw = False
        if self._atlas is not None:
            from ..textures.atlas import RAW
            kinds = np.asarray(self._atlas.kind)
            ids = set()
            for r in self._materials._rows:
                for k in ("tex", "tex_no", "tex_pmdg"):
                    v = r.get(k, -1)
                    if v is not None and int(v) >= 0:
                        ids.add(int(v))
            mat_tex_raw = all(int(kinds[i]) == RAW for i in ids)

        scene = Scene(
            materials=self._materials.build(),
            background=self._background,
            mat_tex_raw=mat_tex_raw,
            spheres=spheres,
            sphere_bvh=sphere_bvh,
            triangles=triangles,
            tlas=tlas,
            volumes=volumes,
            mesh_volumes=mesh_volumes,
            voxels=tuple(self._voxels) or None,
            atlas=self._atlas,
            needs_alpha=(self._atlas is not None
                         and self._materials.may_alpha_test()),
            has_mix=self._materials.has_mix(),
        )
        return attach_lights(scene) if nee else scene
