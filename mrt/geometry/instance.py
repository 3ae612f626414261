"""Instanced meshes: a two-level BVH (TLAS over BLAS) in one stackless loop.

The reference's `Model` wraps a triangle BVH behind an `Arc` and
`Instance` adds a TRS transform + inverse, intersecting by warping the
ray into object space and the hit back out
(reference: src/geom.rs:275-425).  A `Model` with a material override is
an identity-transform instance here (geom.rs:317-333 override semantics:
the hit's material row is replaced).

Design: all meshes' BVH node and triangle arrays are concatenated
("mega-BLAS"); a top-level BVH (TLAS) is built over instance world-space
AABBs with 1 instance per leaf.  A wavefront of rays traverses both
levels in a single `lax.while_loop`: each ray carries
  (level, node, resume, instance, o_local, d_local)
where entering a TLAS leaf warps the ray by the instance's inverse
transform (geom.rs:404-407) and jumps to the instance mesh's BLAS root;
finishing a BLAS jumps back to the saved TLAS resume node.  Hit t values
are affine-invariant, so best-t shrinks globally across instances just
like the reference's closest_so_far.

Winners are transformed back to world space: point by the forward
transform, normal by the forward linear part then renormalised — the
reference uses the same (not inverse-transpose) convention
(geom.rs:410-414), so nonuniform-scale normals match it exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from .hit import Hits, set_face_normal, INF
from .triangles import Triangles, DET_EPS
from . import bvh as bvh_mod
from .bvh import FlatBVH, _slab_test, LEAF_SIZE

# f32 geometry products must not drop to TF32 on a GPU: a ~1e-3
# relative error in a ray warp or a normal moves or flips hits.
HIGHEST = jax.lax.Precision.HIGHEST

# Flat-table size cap: bytes of BVH nodes (48 B) plus triangles
# (36 B) that a world-flattened build may duplicate into.
FLAT_TABLE_BYTES = 448 * 1024


def _flat_fits(n_nodes: int, n_tris: int) -> bool:
    return n_nodes * 48 + n_tris * 36 < FLAT_TABLE_BYTES


@struct.dataclass
class TLAS:
    # Top level (over instances; 1 instance per leaf)
    t_bmin: jnp.ndarray     # (Mt,3)
    t_bmax: jnp.ndarray     # (Mt,3)
    t_inst: jnp.ndarray     # (Mt,) instance id for leaves, -1 internal
    t_escape: jnp.ndarray   # (Mt,)
    # Instances
    transform: jnp.ndarray      # (I,4,4) object->world
    inv_transform: jnp.ndarray  # (I,4,4)
    override: jnp.ndarray       # (I,) material row, -1 = keep triangle's
    blas_root: jnp.ndarray      # (I,) global BLAS node index
    blas_end: jnp.ndarray       # (I,) global BLAS end index
    # Mega-BLAS (all meshes concatenated)
    bmin: jnp.ndarray       # (Mb,3)
    bmax: jnp.ndarray       # (Mb,3)
    first: jnp.ndarray      # (Mb,) global triangle index
    count: jnp.ndarray      # (Mb,)
    escape: jnp.ndarray     # (Mb,) global node index
    tris: Triangles         # concatenated, BVH-ordered
    # Per-instance global triangle range of the instance's mesh —
    # consumed by the gather-free instanced brute path
    # (geometry/tlas_brute.py); None on pre-existing pytrees.
    tri_first: jnp.ndarray = None   # (I,)
    tri_count: jnp.ndarray = None   # (I,)
    # Per-instance world AABBs exactly as built into the TLAS leaves —
    # every traversal path must cull against these same boxes so the
    # deterministic winner is path-independent (a device-side einsum
    # recompute can differ by ulps and flip a grazing cull).
    w_min: jnp.ndarray = None       # (I,3)
    w_max: jnp.ndarray = None       # (I,3)
    # World-flattened single-level representation: every instance's
    # triangles pre-transformed to world space under one BVH, so small
    # instanced scenes can take the single-level traversal instead of
    # the two-level one.  Built only when the
    # world triangle count is small (MeshRegistry.FLAT_MAX_TRIS); None
    # otherwise and on pre-existing pytrees.
    flat_tris: Any = None           # Triangles (unit_normal=True)
    flat_bvh: Any = None            # bvh.FlatBVH
    # Mid-size fallback: the same world flattening split into spatial
    # instance clusters, each under the flat size cap; rays fold the
    # per-part raw winners and one shared expansion recovers the exact
    # instanced shading semantics.
    flat_parts: Any = None          # tuple[FlatPart, ...]

    @property
    def n_tlas_nodes(self):
        return self.t_bmin.shape[0]


@struct.dataclass
class FlatPart:
    """One spatial cluster of world-flattened instances.

    `tris` carries world-space geometry only (shading fields zeroed —
    the winner expansion goes through instance.expand_winner with the
    (instance, BLAS-triangle) pair recovered from `packed`, so
    shading is bit-identical to the two-level path)."""
    tris: Any               # Triangles, world space, BVH order
    bvh: Any                # bvh.FlatBVH
    packed: jnp.ndarray     # (Tp,) i32: (instance << 20) | global tri


class MeshRegistry:
    """Host-side accumulator: register meshes once, instance them many
    times (the reference's `Arc<BvhNode>` sharing, geom.rs:312-314)."""

    def __init__(self):
        self._meshes = []       # list[(FlatBVH-np, Triangles)]
        self._instances = []    # list[dict]

    def add_mesh(self, tris: Triangles, leaf_size=LEAF_SIZE,
                 split=None) -> int:
        bvh, reordered = bvh_mod.build_over_triangles(tris, leaf_size,
                                                      split=split)
        self._meshes.append((bvh, reordered))
        return len(self._meshes) - 1

    def add_instance(self, mesh_id, translation=(0, 0, 0),
                     rotation=(0, 0, 0), scale=(1, 1, 1), material=None):
        """rotation in turns, like the reference (math.rs:184-215)."""
        self._instances.append(dict(
            mesh=mesh_id,
            translation=np.asarray(translation, np.float32),
            rotation=np.asarray(np.broadcast_to(rotation, (3,)), np.float32),
            scale=np.asarray(np.broadcast_to(scale, (3,)), np.float32),
            material=-1 if material is None else int(material)))
        return len(self._instances) - 1

    def build(self) -> TLAS:
        from ..math import m4

        if not self._instances:
            raise ValueError("no instances registered")

        # Concatenate BLAS arrays with offsets.
        node_off, tri_off = [], []
        bmins, bmaxs, firsts, counts, escapes = [], [], [], [], []
        tris_list = []
        n_nodes = n_tris = 0
        for bvh, tris in self._meshes:
            node_off.append(n_nodes)
            tri_off.append(n_tris)
            bmins.append(np.asarray(bvh.bmin))
            bmaxs.append(np.asarray(bvh.bmax))
            firsts.append(np.asarray(bvh.first) + n_tris)
            counts.append(np.asarray(bvh.count))
            escapes.append(np.asarray(bvh.escape) + n_nodes)
            tris_list.append(tris)
            n_nodes += bvh.n_nodes
            n_tris += tris.count

        # Concatenate on host, convert to device arrays exactly once
        # (mesh leaves are NumPy until here; see Triangles.from_soup).
        tris = jax.tree.map(
            lambda *xs: jnp.asarray(
                np.concatenate([np.asarray(x) for x in xs], axis=0)),
            *tris_list)

        # Per-instance transforms + world AABBs from the 8 transformed
        # corners of the mesh root box (geom.rs:369-381) — vectorised:
        # Menger-scale scenes register millions of instances
        # (scenes/menger.rs) and a per-instance Python loop would
        # dominate the build.
        n_inst = len(self._instances)
        tr = np.stack([i["translation"] for i in self._instances])
        ro = np.stack([i["rotation"] for i in self._instances])
        sc = np.stack([i["scale"] for i in self._instances])
        mesh_ids = np.array([i["mesh"] for i in self._instances],
                            np.int32)
        override = np.array([i["material"] for i in self._instances],
                            np.int32)

        fwd = m4.trs_batch_np(tr, ro, sc)
        inv = m4.trs_inverse_batch_np(tr, ro, sc)

        node_off_arr = np.array(node_off, np.int32)
        nodes_per = np.array([m[0].n_nodes for m in self._meshes],
                             np.int32)
        roots = node_off_arr[mesh_ids]
        ends = roots + nodes_per[mesh_ids]

        tri_off_arr = np.array(tri_off, np.int32)
        tris_per = np.array([m[1].va.shape[0] for m in self._meshes],
                            np.int32)
        inst_tri_first = tri_off_arr[mesh_ids]
        inst_tri_count = tris_per[mesh_ids]

        mesh_root_min = np.stack(
            [np.asarray(m[0].bmin[0]) for m in self._meshes])[mesh_ids]
        mesh_root_max = np.stack(
            [np.asarray(m[0].bmax[0]) for m in self._meshes])[mesh_ids]
        combos = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                           for z in (0, 1)], np.float32)          # (8,3)
        corners = (mesh_root_min[:, None, :] * (1.0 - combos[None])
                   + mesh_root_max[:, None, :] * combos[None])    # (I,8,3)
        wc = (np.einsum("iab,icb->ica", fwd[:, :3, :3], corners)
              + fwd[:, None, :3, 3])
        w_min = wc.min(axis=1)
        w_max = wc.max(axis=1)

        # TLAS over instance boxes, one instance per leaf.
        cent = (w_min + w_max) / 2.0
        (t_bmin, t_bmax, t_first, t_count, t_escape), order = bvh_mod.build(
            cent, w_min, w_max, leaf_size=1)
        # Leaves reference reordered instances; map back to instance ids.
        t_inst = np.where(t_count > 0, order[np.minimum(
            t_first, n_inst - 1)], -1).astype(np.int32)

        import os as _os
        split_env = _os.environ.get("MRT_FLAT_SPLIT", "")
        flat_tris = flat_bvh = None
        if not split_env:
            flat_tris, flat_bvh = self._build_flat(
                mesh_ids, fwd, override, int(inst_tri_count.sum()))
        flat_parts = None
        # The clustered flatten is opt-in: build the part arrays only
        # when requested, so default builds carry no dead device tables.
        if flat_tris is None and (
                split_env
                or _os.environ.get("MRT_TLAS_KERNEL") in ("flat",
                                                          "auto")):
            flat_parts = self._build_flat_parts(
                mesh_ids, fwd, w_min, w_max, inst_tri_first,
                inst_tri_count,
                part_tris=int(split_env) if split_env else None)

        return TLAS(
            flat_tris=flat_tris, flat_bvh=flat_bvh,
            flat_parts=flat_parts,
            t_bmin=jnp.asarray(t_bmin), t_bmax=jnp.asarray(t_bmax),
            t_inst=jnp.asarray(t_inst), t_escape=jnp.asarray(t_escape),
            transform=jnp.asarray(fwd), inv_transform=jnp.asarray(inv),
            override=jnp.asarray(override), blas_root=jnp.asarray(roots),
            blas_end=jnp.asarray(ends),
            bmin=jnp.asarray(np.concatenate(bmins)),
            bmax=jnp.asarray(np.concatenate(bmaxs)),
            first=jnp.asarray(np.concatenate(firsts)),
            count=jnp.asarray(np.concatenate(counts)),
            escape=jnp.asarray(np.concatenate(escapes)),
            tris=tris,
            tri_first=jnp.asarray(inst_tri_first),
            tri_count=jnp.asarray(inst_tri_count),
            w_min=jnp.asarray(w_min.astype(np.float32)),
            w_max=jnp.asarray(w_max.astype(np.float32)))


    # World-flattening ceiling, total triangles across all instances
    # (each instance duplicates its mesh's triangles).  Menger-class
    # scenes (millions of world tris) skip the build; `_flat_fits`
    # then caps the built tables' size exactly.
    FLAT_MAX_TRIS = 12288

    def _build_flat(self, mesh_ids, fwd, override, world_tris):
        """World-flatten every instance's triangles into one Triangles
        set + single-level BVH (host NumPy), or (None, None) when the
        scene is too big.

        The instanced hit semantics are preserved exactly (geom.rs:
        404-414 via instance.expand_winner): vertices and edges by the
        forward affine transform; per-vertex normals and the tangent
        frame by the forward *linear* part (not inverse-transpose),
        with normalisation deferred to hit time (Triangles.unit_normal
        — the transform is linear, so interpolating transformed
        normals equals transforming the interpolated normal); material
        overrides baked per triangle (geom.rs:317-333)."""
        if world_tris > self.FLAT_MAX_TRIS:
            return None, None

        import jax as _jax

        chunks = []
        by_mesh = {}
        for i, m in enumerate(mesh_ids):
            by_mesh.setdefault(int(m), []).append(i)
        for m, idx in sorted(by_mesh.items()):
            tris = self._meshes[m][1]
            a = fwd[idx][:, :3, :3]                        # (K,3,3)
            b = fwd[idx][:, :3, 3]                         # (K,3)
            ov = override[idx]                             # (K,)
            k, tm = len(idx), tris.va.shape[0]
            pt = lambda x: (np.einsum("kab,tb->kta", a, np.asarray(x))
                            + b[:, None, :]).reshape(-1, 3)
            ln = lambda x: np.einsum(
                "kab,tb->kta", a, np.asarray(x)).reshape(-1, 3)
            tile = lambda x: np.broadcast_to(
                np.asarray(x)[None], (k,) + np.asarray(x).shape
            ).reshape((-1,) + np.asarray(x).shape[1:])
            mat = np.where(ov[:, None] >= 0, ov[:, None],
                           np.asarray(tris.material)[None, :])
            chunks.append(Triangles(
                va=pt(tris.va), e_ab=ln(tris.e_ab), e_ac=ln(tris.e_ac),
                na=ln(tris.na), nb=ln(tris.nb), nc=ln(tris.nc),
                uva=tile(tris.uva), uvb=tile(tris.uvb),
                uvc=tile(tris.uvc),
                tangent=ln(tris.tangent), bitangent=ln(tris.bitangent),
                material=mat.reshape(-1).astype(np.int32),
                has_uv=tile(tris.has_uv),
                unit_normal=True))
        flat = _jax.tree.map(
            lambda *xs: np.concatenate(xs, axis=0).astype(xs[0].dtype),
            *chunks) if len(chunks) > 1 else chunks[0]
        flat_bvh, flat = bvh_mod.build_over_triangles(flat)
        if not _flat_fits(flat_bvh.n_nodes, flat.va.shape[0]):
            return None, None
        return (_jax.tree.map(jnp.asarray, flat),
                _jax.tree.map(jnp.asarray, flat_bvh))

    # Clustered-flatten limits: total world tris worth duplicating,
    # per-part ceiling under the flat size cap, and the packed
    # (instance << 20 | tri) i32 encoding bounds.
    FLAT_PARTS_MAX_TRIS = 1 << 17
    FLAT_PART_TRIS = 9216

    def _build_flat_parts(self, mesh_ids, fwd, w_min, w_max,
                          tri_first, tri_count, part_tris=None):
        """Partition instances into spatial clusters and world-flatten
        each under its own single-level BVH (geometry only — winner
        expansion recovers (instance, BLAS triangle) from `packed` and
        goes through expand_winner, so shading semantics are exactly
        the two-level path's).  Returns a tuple of FlatPart or None
        when the scene is too big / encoding doesn't fit."""
        n_inst = len(mesh_ids)
        total = int(tri_count.sum())
        ceil = part_tris or self.FLAT_PART_TRIS
        if ((part_tris is None and total <= self.FLAT_MAX_TRIS)
                or total > self.FLAT_PARTS_MAX_TRIS
                or n_inst >= 2048
                or int(tri_first.max() + tri_count.max()) >= 1 << 20):
            return None
        if int(tri_count.max()) > ceil:
            return None  # one instance alone overflows a part table

        import jax as _jax

        cent = ((w_min + w_max) * 0.5).astype(np.float64)
        counts = np.asarray(tri_count, np.int64)

        def split(idx):
            if counts[idx].sum() <= ceil or len(idx) == 1:
                return [idx]
            ext = cent[idx].max(axis=0) - cent[idx].min(axis=0)
            ax = int(np.argmax(ext))
            order = idx[np.argsort(cent[idx, ax], kind="stable")]
            cum = np.cumsum(counts[order])
            half = int(np.searchsorted(cum, cum[-1] / 2.0))
            half = min(max(half, 1), len(order) - 1)
            return split(order[:half]) + split(order[half:])

        parts = []
        for idx in split(np.arange(n_inst)):
            vas, eabs, eacs, packs = [], [], [], []
            for i in idx:
                tris = self._meshes[mesh_ids[i]][1]
                a, b = fwd[i, :3, :3], fwd[i, :3, 3]
                vas.append(np.asarray(tris.va) @ a.T + b)
                eabs.append(np.asarray(tris.e_ab) @ a.T)
                eacs.append(np.asarray(tris.e_ac) @ a.T)
                g = np.arange(tris.va.shape[0], dtype=np.int64)
                packs.append((np.int64(i) << 20)
                             | (np.int64(tri_first[i]) + g))
            va = np.concatenate(vas).astype(np.float32)
            eab = np.concatenate(eabs).astype(np.float32)
            eac = np.concatenate(eacs).astype(np.float32)
            packed = np.concatenate(packs)
            assert packed.max() < np.iinfo(np.int32).max

            vb, vc = va + eab, va + eac
            bmin = np.minimum(np.minimum(va, vb), vc)
            bmax = np.maximum(np.maximum(va, vb), vc)
            (nb_min, nb_max, first, count, escape), order = bvh_mod.build(
                (va + vb + vc) / 3.0, bmin, bmax, LEAF_SIZE)
            if not _flat_fits(nb_min.shape[0], va.shape[0]):
                return None
            t = va.shape[0]
            zeros3 = np.zeros((t, 3), np.float32)
            zeros2 = np.zeros((t, 2), np.float32)
            part_tris = Triangles(
                va=va[order], e_ab=eab[order], e_ac=eac[order],
                na=zeros3, nb=zeros3, nc=zeros3,
                uva=zeros2, uvb=zeros2, uvc=zeros2,
                tangent=zeros3, bitangent=zeros3,
                material=np.zeros((t,), np.int32),
                has_uv=np.zeros((t,), bool),
                unit_normal=True)
            parts.append(FlatPart(
                tris=_jax.tree.map(jnp.asarray, part_tris),
                bvh=_jax.tree.map(jnp.asarray, FlatBVH(
                    bmin=nb_min.astype(np.float32),
                    bmax=nb_max.astype(np.float32),
                    first=first, count=count, escape=escape)),
                packed=jnp.asarray(packed[order].astype(np.int32))))
        return tuple(parts)


def wants_flat(tlas: TLAS) -> bool:
    """Route this TLAS through its world-flattened single-level BVH?
    Opt-in: MRT_TLAS_KERNEL=flat or =auto, when the flat tables were
    built (MeshRegistry._build_flat)."""
    import os
    if tlas is None or tlas.flat_tris is None:
        return False
    return os.environ.get("MRT_TLAS_KERNEL", "") in ("flat", "auto")


def wants_flat_parts(tlas: TLAS) -> bool:
    """Route through the clustered flatten (same opt-in as wants_flat)."""
    import os
    if tlas is None or tlas.flat_parts is None:
        return False
    return os.environ.get("MRT_TLAS_KERNEL", "") in ("flat", "auto")


def intersect_tlas_flat_parts(tlas: TLAS, o, d, t_min, t_max) -> Hits:
    """Fold per-cluster single-level traversals into one winner.

    Tie rule: strictly closer t wins; equal t keeps the EARLIER part
    (parts are disjoint spatial clusters, so cross-part exact ties
    require coincident geometry).  Within a part the kernel's
    lower-triangle-index rule applies.  The final (instance, triangle)
    is recovered from the winning row's packed id — one (N,) gather —
    and expanded by expand_winner, bit-identical shading semantics to
    the two-level traversal."""
    od = jnp.sum(o * d, axis=-1)
    best_t = jnp.full_like(od, INF)
    best_row = jnp.zeros_like(od, dtype=jnp.int32)
    best_u = jnp.zeros_like(od)
    best_v = jnp.zeros_like(od)
    offset = 0
    for part in tlas.flat_parts:
        t, i, u, v = bvh_mod.intersect_bvh_tris(
            part.tris, part.bvh, o, d, t_min, t_max)
        ok = t < best_t
        best_row = jnp.where(ok, i + jnp.int32(offset), best_row)
        best_u = jnp.where(ok, u, best_u)
        best_v = jnp.where(ok, v, best_v)
        best_t = jnp.where(ok, t, best_t)
        offset += int(part.packed.shape[0])
    packed = jnp.concatenate(
        [p.packed for p in tlas.flat_parts])[best_row]
    inst = packed >> 20
    gtri = packed & ((1 << 20) - 1)
    return expand_winner(tlas, o, d, best_t, inst, gtri, best_u,
                         best_v)


def intersect_tlas(tlas: TLAS, o, d, t_min, t_max, scene=None) -> Hits:
    """Closest hit over all instances for a wavefront of rays."""
    n = o.shape[0]
    mt = tlas.n_tlas_nodes
    tris = tlas.tris
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    od = jnp.sum(o * d, axis=-1)
    i32 = lambda v: jnp.full_like(od, v, dtype=jnp.int32)
    state = (
        i32(0),                    # node: TLAS index (inst<0) else BLAS
        i32(-1),                   # inst: current instance, -1 = in TLAS
        i32(mt),                   # resume: TLAS node after current BLAS
        o, d,                      # local-space ray while inside a BLAS
        jnp.full_like(od, INF),    # best t
        i32(-1),                   # best instance
        i32(0),                    # best triangle
        jnp.zeros_like(od),        # best u
        jnp.zeros_like(od),        # best v
    )

    def cond(s):
        node, inst = s[0], s[1]
        return jnp.any((inst >= 0) | (node < mt))

    def step(s):
        (node, inst, resume, o_l, d_l, best_t, best_inst, best_tri,
         best_u, best_v) = s
        in_blas = inst >= 0
        lim = jnp.minimum(best_t, t_max)

        # ---- TLAS step (rays with inst == -1) ---------------------------
        t_active = ~in_blas & (node < mt)
        t_ni = jnp.clip(node, 0, mt - 1)
        t_hit = _slab_test(tlas.t_bmin[t_ni], tlas.t_bmax[t_ni], o,
                           1.0 / d, t_min, lim) & t_active
        leaf_inst = tlas.t_inst[t_ni]
        t_is_leaf = leaf_inst >= 0
        enter = t_hit & t_is_leaf

        # Entering an instance: warp the ray into object space
        # (geom.rs:404-407) and jump to its BLAS root.
        e_inst = jnp.clip(leaf_inst, 0, tlas.transform.shape[0] - 1)
        inv_t = tlas.inv_transform[e_inst]                   # (N,4,4)
        o_enter = (jnp.einsum("nij,nj->ni", inv_t[:, :3, :3], o,
                               precision=HIGHEST)
                   + inv_t[:, :3, 3])
        d_enter = jnp.einsum("nij,nj->ni", inv_t[:, :3, :3], d,
                             precision=HIGHEST)

        tlas_next = jnp.where(t_hit & ~t_is_leaf, t_ni + 1,
                              tlas.t_escape[t_ni])

        new_inst = jnp.where(enter, leaf_inst, inst)
        new_resume = jnp.where(enter, tlas.t_escape[t_ni], resume)
        new_node = jnp.where(t_active,
                             jnp.where(enter, tlas.blas_root[e_inst],
                                       tlas_next),
                             node)
        new_o = jnp.where(enter[:, None], o_enter, o_l)
        new_d = jnp.where(enter[:, None], d_enter, d_l)

        # ---- BLAS step (rays with inst >= 0) ----------------------------
        b_end = tlas.blas_end[jnp.clip(inst, 0, None)]
        b_active = in_blas
        b_ni = jnp.clip(node, 0, tlas.bmin.shape[0] - 1)
        b_hit = _slab_test(tlas.bmin[b_ni], tlas.bmax[b_ni], o_l,
                           1.0 / d_l, t_min, lim) & b_active
        count = tlas.count[b_ni]
        first = tlas.first[b_ni]
        b_is_leaf = count > 0
        do_test = b_hit & b_is_leaf

        bt, bi, bu, bv = best_t, best_tri, best_u, best_v
        b_inst = best_inst
        for j in range(LEAF_SIZE):
            ti = jnp.clip(first + j, 0, tris.count - 1)
            valid = do_test & (j < count)
            ab = tris.e_ab[ti]
            ac = tris.e_ac[ti]
            va = tris.va[ti]
            p = jnp.cross(d_l, ac)
            det = jnp.sum(ab * p, axis=-1)
            det_ok = jnp.abs(det) >= DET_EPS
            inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
            tv = o_l - va
            u = jnp.sum(tv * p, axis=-1) * inv_det
            q = jnp.cross(tv, ab)
            v = jnp.sum(d_l * q, axis=-1) * inv_det
            t = jnp.sum(ac * q, axis=-1) * inv_det
            # Deterministic tie rule: strictly closer wins; equal t ->
            # lexicographic lower (instance, triangle).  Order-invariant,
            # so any traversal order (and tlas_brute) finds the same
            # winner.
            ok = (valid & det_ok
                  & (u >= 0.0) & (u <= 1.0)
                  & (v >= 0.0) & (u + v <= 1.0)
                  & (t >= t_min) & (t <= t_max)
                  & ((t < bt) | ((t == bt)
                                 & ((inst < b_inst)
                                    | ((inst == b_inst) & (ti < bi))))))
            bi = jnp.where(ok, ti, bi)
            bu = jnp.where(ok, u, bu)
            bv = jnp.where(ok, v, bv)
            b_inst = jnp.where(ok, inst, b_inst)
            bt = jnp.where(ok, t, bt)

        blas_next = jnp.where(b_hit & ~b_is_leaf, b_ni + 1,
                              tlas.escape[b_ni])
        exiting = b_active & (blas_next >= b_end)
        new_node = jnp.where(b_active,
                             jnp.where(exiting, resume, blas_next),
                             new_node)
        new_inst = jnp.where(exiting, -1, new_inst)

        return (new_node, new_inst, new_resume, new_o, new_d,
                bt, b_inst, bi, bu, bv)

    (_, _, _, _, _, best_t, best_inst, best_tri, best_u,
     best_v) = jax.lax.while_loop(cond, step, state)
    return expand_winner(tlas, o, d, best_t, best_inst, best_tri,
                         best_u, best_v)


def expand_winner(tlas: TLAS, o, d, best_t, best_inst, best_tri,
                  best_u, best_v) -> Hits:
    """Expand per-ray (t, instance, triangle, u, v) winners to a Hits
    record in world space (shared by every TLAS traversal)."""
    from .triangles import shading_table, unpack_shading

    tris = tlas.tris
    # ---- expand winner: two packed row reads (triangle, instance) ---------
    hit = jnp.isfinite(best_t)
    inst = jnp.clip(best_inst, 0, None)
    ti = best_tri
    w = (1.0 - best_u - best_v)[:, None]
    uu, vv = best_u[:, None], best_v[:, None]

    s = unpack_shading(shading_table(tris)[ti])
    normal_l = s["na"] * w + s["nb"] * uu + s["nc"] * vv
    uv = s["uva"] * w + s["uvb"] * uu + s["uvc"] * vv
    uv = jnp.where(s["has_uv"][:, None], uv, 0.0)

    # Instance row: forward linear part (9) + override (1).
    inst_table = jnp.concatenate(
        [tlas.transform[:, :3, :3].reshape(-1, 9),
         tlas.override.astype(jnp.float32)[:, None]], axis=-1)
    irow = inst_table[inst]
    lin = irow[:, :9].reshape(-1, 3, 3)
    ov = jnp.round(irow[:, 9]).astype(jnp.int32)

    # World normal: forward linear part then unit (geom.rs:412 — the
    # reference does not use the inverse-transpose; we match it).
    normal_w = jnp.einsum("nij,nj->ni", lin, normal_l,
                          precision=HIGHEST)
    norm = jnp.sqrt(jnp.sum(normal_w * normal_w, axis=-1, keepdims=True))
    normal_w = normal_w / jnp.maximum(norm, 1e-20)

    t_safe = jnp.where(hit, best_t, 0.0)
    point = o + d * t_safe[:, None]  # t is affine-invariant

    material = jnp.where(ov >= 0, ov, s["material"])

    # Tangent frame to world space with the same forward-linear
    # convention as the normal (unnormalised, like the reference's
    # object-space tangents, geom.rs:556-560).
    tangent_w = jnp.einsum("nij,nj->ni", lin, s["tangent"],
                          precision=HIGHEST)
    bitangent_w = jnp.einsum("nij,nj->ni", lin, s["bitangent"],
                             precision=HIGHEST)

    normal_w, front_face = set_face_normal(d, normal_w)
    # World-space triangle area for the MIS light pdf: transform the
    # edges by the instance's forward linear part.
    e1_w = jnp.einsum("nij,nj->ni", lin, s["e_ab"], precision=HIGHEST)
    e2_w = jnp.einsum("nij,nj->ni", lin, s["e_ac"], precision=HIGHEST)
    area_w = 0.5 * jnp.linalg.norm(jnp.cross(e1_w, e2_w), axis=-1)
    return Hits(
        t=jnp.where(hit, best_t, INF),
        point=point,
        normal=normal_w,
        front_face=front_face,
        uv=uv,
        material=material,
        hit=hit,
        tangent=tangent_w,
        bitangent=bitangent_w,
        prim_area=jnp.where(hit, area_w, 0.0),
    )
