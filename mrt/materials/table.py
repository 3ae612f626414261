"""SoA material table.

The reference dispatches materials through `&dyn Material`
(src/material.rs:15-27).  Here every material in a scene is a row in a
flat table; a hit carries a row index, and shading evaluates all material
classes branch-free on the VPU and masks by type (see mrt.materials.shade).

Material classes (mirroring the reference inventory, src/material.rs):
    LAMBERTIAN     cosine-ish scatter, albedo from surface (mat.rs:192-225)
    METAL          mirror + fuzz, absorbs below-horizon    (mat.rs:248-284)
    DIELECTRIC     stochastic Fresnel reflect/refract      (mat.rs:286-329)
    DIFFUSE_LIGHT  no scatter, constant emission           (mat.rs:227-246)
    ISOTROPIC      uniform-ball scatter (volumes)          (mat.rs:428-445)
    SPECULAR       Fresnel-gated clear coat over Lambertian(mat.rs:331-383)
    MIX            stochastic blend of two table rows      (mat.rs:391-426)
    NULL           never scatters (the `()` material,       mat.rs:385-389)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..utils import struct

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3
ISOTROPIC = 4
SPECULAR = 5
MIX = 6
NULL = 7
# Packed-PBR ship material (reference: src/eve.rs:91-134): three packed
# textures (albedo+roughness, normal+occlusion, paint/material/dirt/glow
# masks), a 4-color faction palette, and a glow color; shades as a
# per-hit Mix(roughness+dirt, Lambertian, Specular(1.8)).
EVE = 8

# Maximum depth of nested Mix materials resolved per event.  The reference
# supports arbitrary nesting via recursion; in practice scenes nest <= 2
# (e.g. eve.rs Mix(Lambertian, Specular)).
MAX_MIX_DEPTH = 4

NO_TEXTURE = -1


@struct.dataclass
class MaterialTable:
    mtype: jnp.ndarray      # (M,)  int32, one of the class ids above
    albedo: jnp.ndarray     # (M,4) rgba solid color (a drives alpha_test)
    tex: jnp.ndarray        # (M,)  int32 texture id, NO_TEXTURE for solid
    fuzz: jnp.ndarray       # (M,)  metal fuzz (clamped <= 1 at build)
    ior: jnp.ndarray        # (M,)  refraction index (dielectric/specular)
    emit: jnp.ndarray       # (M,3) emission (diffuse light)
    mix_ratio: jnp.ndarray  # (M,)  P(choose left) for MIX rows
    mix_left: jnp.ndarray   # (M,)  int32 table row
    mix_right: jnp.ndarray  # (M,)  int32 table row
    # EVE rows (NO_TEXTURE elsewhere): `tex` holds albedo+roughness.
    tex_no: jnp.ndarray     # (M,)  normal+occlusion texture id
    tex_pmdg: jnp.ndarray   # (M,)  paint/material/dirt/glow texture id
    palette: jnp.ndarray    # (M,4,3) faction colors (eve.rs:136-198)
    glow3: jnp.ndarray      # (M,3) glow color
    # Static: the table's ACTUAL max Mix nesting depth (host-computed
    # at build).  shade.resolve_mix iterates only this many levels —
    # bit-exact vs iterating MAX_MIX_DEPTH, since a level with no MIX
    # rows left maps every row to itself, but each elided level saves
    # a full-table one-hot fetch in BOTH the emission and scatter
    # streams (eve: depth 1, was 4).  Sampler draws are unchanged
    # (resolve_rows always advances MAX_MIX_DEPTH draws).
    mix_depth: int = struct.field(pytree_node=False,
                                  default=MAX_MIX_DEPTH)

    @property
    def count(self):
        return self.mtype.shape[0]

    @property
    def params(self):
        """Packed hot parameters [albedo4, fuzz, ior, emit3] (M,9):
        shading gathers this matrix ONCE per wavefront instead of 5+
        separate table gathers.  Computed on the fly so field updates (e.g. inverse rendering
        optimising `albedo`) can never go stale; the concat is tiny
        (M rows) and fuses."""
        return jnp.concatenate(
            [self.albedo, self.fuzz[:, None], self.ior[:, None],
             self.emit], axis=1)

    # Column layout of `packed` (first 9 columns == `params`).
    C_MTYPE = 9
    C_TEX = 10
    C_TEX_PMDG = 11
    C_TEX_NO = 12
    C_GLOW = slice(13, 16)
    C_PALETTE = slice(16, 28)
    C_MIX_RATIO = 28
    C_MIX_LEFT = 29
    C_MIX_RIGHT = 30

    @property
    def packed(self):
        """EVERY column in one (M,31) f32 matrix so any shading path
        resolves a wavefront's material data with ONE row read instead
        of per-column gathers (the EVE path alone touches 8+ columns).
        Identical-argument reads CSE inside one jitted step."""
        f = lambda x: x.astype(jnp.float32)[:, None]
        return jnp.concatenate(
            [self.params,                          # 0:9
             f(self.mtype),                        # 9
             f(self.tex),                          # 10
             f(self.tex_pmdg),                     # 11
             f(self.tex_no),                       # 12
             self.glow3,                           # 13:16
             self.palette.reshape(-1, 12),         # 16:28
             self.mix_ratio[:, None],              # 28
             f(self.mix_left),                     # 29
             f(self.mix_right),                    # 30
             ], axis=1)


class MaterialBuilder:
    """Host-side accumulator producing a MaterialTable.

    Every add_* returns the integer row id used by geometry.
    """

    def __init__(self):
        self._rows = []

    def _add(self, mtype, albedo=(0, 0, 0, 1), tex=NO_TEXTURE, fuzz=0.0,
             ior=1.0, emit=(0, 0, 0), mix_ratio=0.0, mix_left=0,
             mix_right=0, tex_no=NO_TEXTURE, tex_pmdg=NO_TEXTURE,
             palette=((0,) * 3,) * 4, glow3=(0, 0, 0)):
        self._rows.append(dict(
            mtype=mtype, albedo=tuple(albedo), tex=tex, fuzz=fuzz, ior=ior,
            emit=tuple(emit), mix_ratio=mix_ratio, mix_left=mix_left,
            mix_right=mix_right, tex_no=tex_no, tex_pmdg=tex_pmdg,
            palette=tuple(tuple(c) for c in palette), glow3=tuple(glow3)))
        return len(self._rows) - 1

    def lambertian(self, albedo=(1.0, 1.0, 1.0, 1.0), tex=NO_TEXTURE):
        albedo = tuple(albedo) + (1.0,) * (4 - len(tuple(albedo)))
        return self._add(LAMBERTIAN, albedo=albedo, tex=tex)

    def metal(self, fuzz=0.0, albedo=(1.0, 1.0, 1.0, 1.0), tex=NO_TEXTURE):
        albedo = tuple(albedo) + (1.0,) * (4 - len(tuple(albedo)))
        # Reference clamps fuzz at construction (material.rs:255-258).
        return self._add(METAL, albedo=albedo, tex=tex, fuzz=min(fuzz, 1.0))

    def dielectric(self, refraction_index):
        return self._add(DIELECTRIC, ior=refraction_index)

    def diffuse_light(self, emit):
        return self._add(DIFFUSE_LIGHT, emit=tuple(emit))

    def isotropic(self, albedo):
        albedo = tuple(albedo) + (1.0,) * (4 - len(tuple(albedo)))
        return self._add(ISOTROPIC, albedo=albedo)

    def specular(self, refraction_index, albedo=(1.0, 1.0, 1.0, 1.0),
                 tex=NO_TEXTURE):
        albedo = tuple(albedo) + (1.0,) * (4 - len(tuple(albedo)))
        return self._add(SPECULAR, albedo=albedo, tex=tex,
                         ior=refraction_index)

    def mix(self, ratio, left, right):
        return self._add(MIX, mix_ratio=ratio, mix_left=left,
                         mix_right=right)

    def null(self):
        return self._add(NULL)

    def eve(self, tex_ar, tex_no, tex_pmdg, palette,
            glow=(0.5, 0.85, 2.0)):
        """Packed-PBR ship material (eve.rs:44-134).

        tex_ar/tex_no/tex_pmdg: atlas ids of the albedo+roughness,
        normal+occlusion and paint/material/dirt/glow textures;
        palette: 4 RGB faction colors lerped by the material mask
        (eve.rs:136-198); glow: emission color scaled by mask * 10.
        """
        return self._add(EVE, tex=tex_ar, ior=1.8, tex_no=tex_no,
                         tex_pmdg=tex_pmdg, palette=palette, glow3=glow)

    def has_mix(self):
        return any(r["mtype"] == MIX for r in self._rows)

    def may_alpha_test(self):
        """True if any row can fail Material::alpha_test — i.e. a
        textured Lambertian/Metal/Specular (material.rs:222-225,
        286-288, 381-383), directly or through a Mix."""
        def can_fail(i, depth=0):
            if depth > MAX_MIX_DEPTH:
                return False
            r = self._rows[i]
            if r["mtype"] == MIX:
                return (can_fail(r["mix_left"], depth + 1)
                        or can_fail(r["mix_right"], depth + 1))
            return (r["mtype"] in (LAMBERTIAN, METAL, SPECULAR)
                    and r["tex"] != NO_TEXTURE)
        return any(can_fail(i) for i in range(len(self._rows)))

    def _check_mix_depth(self):
        """Reject Mix nesting deeper than shading can resolve.

        The reference recurses unboundedly (material.rs:402-407); shading
        here iterates MAX_MIX_DEPTH gathers (shade.resolve_mix), so a
        deeper chain would silently fail to scatter.  Raise at build time
        instead — the table is static, so this is a pure host check.
        """
        def depth(i, seen):
            r = self._rows[i]
            if r["mtype"] != MIX:
                return 0
            if i in seen:
                raise ValueError(
                    f"Mix material row {i} participates in a cycle")
            d = 1 + max(depth(r["mix_left"], seen | {i}),
                        depth(r["mix_right"], seen | {i}))
            return d
        max_d = 0
        for i in range(len(self._rows)):
            d = depth(i, frozenset())
            if d > MAX_MIX_DEPTH:
                raise ValueError(
                    f"Mix material row {i} nests {d} deep; shading "
                    f"resolves at most MAX_MIX_DEPTH={MAX_MIX_DEPTH} "
                    "(raise mrt.materials.table.MAX_MIX_DEPTH or flatten "
                    "the mix tree)")
            max_d = max(max_d, d)
        return max_d

    def build(self) -> MaterialTable:
        if not self._rows:
            self.null()
        mix_depth = self._check_mix_depth()
        rows = self._rows
        f32 = np.float32
        return MaterialTable(
            mtype=jnp.asarray([r["mtype"] for r in rows], jnp.int32),
            albedo=jnp.asarray(np.array([r["albedo"] for r in rows], f32)),
            tex=jnp.asarray([r["tex"] for r in rows], jnp.int32),
            fuzz=jnp.asarray(np.array([r["fuzz"] for r in rows], f32)),
            ior=jnp.asarray(np.array([r["ior"] for r in rows], f32)),
            emit=jnp.asarray(np.array([r["emit"] for r in rows], f32)),
            mix_ratio=jnp.asarray(
                np.array([r["mix_ratio"] for r in rows], f32)),
            mix_left=jnp.asarray([r["mix_left"] for r in rows], jnp.int32),
            mix_right=jnp.asarray(
                [r["mix_right"] for r in rows], jnp.int32),
            tex_no=jnp.asarray([r["tex_no"] for r in rows], jnp.int32),
            tex_pmdg=jnp.asarray(
                [r["tex_pmdg"] for r in rows], jnp.int32),
            palette=jnp.asarray(
                np.array([r["palette"] for r in rows], f32)),
            glow3=jnp.asarray(np.array([r["glow3"] for r in rows], f32)),
            mix_depth=mix_depth,
        )
