"""Bounding volume hierarchy: host build + stackless wavefront traversal.

The reference builds a binary BVH by sorting objects on a *random* axis
and splitting at the median, recursing to 1-2 object leaves
(reference: src/geom.rs:109-162), and traverses it recursively with
t_max shrinking (geom.rs:185-200).  A wavefront has no per-ray call
stack, so this module:

  * builds on host (numpy, iterative) with a *deterministic* widest-axis
    median split (reproducible builds; SURVEY §7) and LEAF_SIZE leaves,
  * flattens depth-first with **escape indices**: node i's subtree is
    skipped by jumping to escape[i], so traversal is a single loop with
    no stack — each ray carries just its current node index,
  * traverses a whole wavefront per step in a `lax.while_loop`: gather
    node AABBs by per-ray index, slab-test, advance to i+1 (hit,
    internal) or escape[i] (miss/leaf-done), and test the LEAF_SIZE
    triangles of hit leaves inline (masked), shrinking per-ray best-t exactly like
    the reference's closest_so_far.

Triangles are reordered at build so leaf primitives are contiguous.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from .hit import INF
from .triangles import Triangles, DET_EPS

# Primitives per BVH leaf — the single source of truth (every traversal
# imports it).  Fatter leaves trade masked per-primitive tests, unrolled
# in the loop body, for fewer node steps.  32 was chosen for an earlier
# accelerator and has not been re-derived on the GPU; MRT_LEAF_SIZE
# sweeps it.  Film means are bit-identical across leaf sizes.
import os as _os

LEAF_SIZE = int(_os.environ.get("MRT_LEAF_SIZE", "32"))


@struct.dataclass
class FlatBVH:
    bmin: jnp.ndarray    # (M,3)
    bmax: jnp.ndarray    # (M,3)
    first: jnp.ndarray   # (M,) first triangle (leaves) / 0
    count: jnp.ndarray   # (M,) triangle count; 0 => internal node
    escape: jnp.ndarray  # (M,) node index to jump to when skipping

    @property
    def n_nodes(self):
        return self.bmin.shape[0]


# Binned-SAH split (MRT_BVH=sah): bins per axis for the surface-area
# heuristic.  Median splits balance counts; SAH minimises expected
# traversal cost (sum of child_area * child_count) — typically fewer
# node visits per ray on irregularly-distributed geometry.
SAH_BINS = 16


def _area(lo, hi):
    """Surface area of AABBs (…,3); 0 for empty (inf/-inf) boxes."""
    d = hi - lo
    ok = np.all(np.isfinite(d), axis=-1) & np.all(d >= 0.0, axis=-1)
    d = np.where(ok[..., None], d, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def _sah_partition(prim, centroids, bounds_min, bounds_max):
    """Best binned-SAH split of `prim`; returns a bool left-mask or
    None (degenerate: all centroids coincide / split separates
    nothing)."""
    c = centroids[prim]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    best_cost = np.inf
    best = None
    for axis in range(3):
        ext = cmax[axis] - cmin[axis]
        if ext <= 0.0:
            continue
        scale = SAH_BINS * (1.0 - 1e-12) / ext
        b = ((c[:, axis] - cmin[axis]) * scale).astype(np.int64)
        cnt = np.bincount(b, minlength=SAH_BINS).astype(np.float64)
        bin_min = np.full((SAH_BINS, 3), np.inf)
        bin_max = np.full((SAH_BINS, 3), -np.inf)
        np.minimum.at(bin_min, b, bounds_min[prim])
        np.maximum.at(bin_max, b, bounds_max[prim])
        # Prefix (left) and suffix (right) accumulations over bins.
        lmin = np.minimum.accumulate(bin_min, axis=0)
        lmax = np.maximum.accumulate(bin_max, axis=0)
        rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
        lcnt = np.cumsum(cnt)
        rcnt = cnt.sum() - lcnt
        # Split k: left bins [0,k], right bins [k+1, BINS).
        la = _area(lmin[:-1], lmax[:-1])
        ra = _area(rmin[1:], rmax[1:])
        cost = (np.where(lcnt[:-1] > 0, lcnt[:-1] * la, 0.0)
                + np.where(rcnt[:-1] > 0, rcnt[:-1] * ra, 0.0))
        valid = (lcnt[:-1] > 0) & (rcnt[:-1] > 0)
        if not valid.any():
            continue
        cost = np.where(valid, cost, np.inf)
        k = int(np.argmin(cost))
        if cost[k] < best_cost:
            best_cost = cost[k]
            best = b <= k
    return best


def build(centroids, bounds_min, bounds_max, leaf_size=LEAF_SIZE,
          split=None):
    """Build a flattened BVH over primitives on host.

    Args:
      centroids: (T,3) primitive centroids.
      bounds_min/bounds_max: (T,3) primitive AABBs.
      split: "median" (default) or "sah" (binned SAH — fewer node
        visits on irregularly-distributed geometry, with bit-identical
        means).  The env
        MRT_BVH overrides the caller's choice either way.
    Returns:
      (FlatBVH arrays as numpy, order) where `order` is the permutation
      to apply to primitive arrays so leaves are contiguous.
    """
    import os as _os
    env = _os.environ.get("MRT_BVH")
    sah = (env or split or "median") == "sah"
    t = centroids.shape[0]
    centroids = np.asarray(centroids, np.float64)
    bounds_min = np.asarray(bounds_min, np.float64)
    bounds_max = np.asarray(bounds_max, np.float64)

    # The C++ builder implements these exact semantics ~100x faster
    # (bit-identical output, both split rules — tests/test_bvh.py);
    # this Python body is the fallback + spec.
    from .. import native
    if t > 1024:
        result = native.bvh_build(centroids, bounds_min, bounds_max,
                                  leaf_size, split_mode=int(sah))
        if result is not None:
            return result

    order = np.arange(t)
    # Worst case 2*ceil(t/leaf... ) nodes; collect then flatten.
    nodes = []  # (bmin, bmax, first|-1, count, left_child, right_child)

    # Recursion via explicit stack: (slice_start, slice_end, parent_slot)
    # Children are placed depth-first: left subtree immediately follows
    # the parent, so flattening is the identity and escape indices can be
    # computed as "index after my subtree".
    def build_range(start, end):
        """Returns node index of the subtree root for order[start:end]."""
        idx = len(nodes)
        prim = order[start:end]
        bmin = bounds_min[prim].min(axis=0)
        bmax = bounds_max[prim].max(axis=0)
        n = end - start
        if n <= leaf_size:
            nodes.append([bmin, bmax, start, n, -1])
            return idx
        mid = None
        if sah:
            mask = _sah_partition(prim, centroids, bounds_min,
                                  bounds_max)
            if mask is not None:
                # Stable two-sided partition keeps determinism.
                order[start:end] = np.concatenate(
                    [prim[mask], prim[~mask]])
                mid = start + int(mask.sum())
        if mid is None:  # median fallback (also SAH-degenerate case)
            c = centroids[prim]
            axis = int(np.argmax(bmax - bmin))
            key = np.argsort(c[:, axis], kind="stable")
            order[start:end] = prim[key]
            mid = start + n // 2
        nodes.append([bmin, bmax, 0, 0, -1])
        build_range(start, mid)
        build_range(mid, end)
        nodes[idx][4] = len(nodes)  # escape = index after my subtree
        return idx

    import sys
    old_limit = sys.getrecursionlimit()
    # SAH trees aren't count-balanced; allow real-world depths well
    # past log2(t) (median stays ~log-deep).
    depth_guess = (20000 if sah
                   else 4 * int(np.log2(max(t, 2)) + 2) * 64)
    sys.setrecursionlimit(max(old_limit, depth_guess))
    try:
        build_range(0, t)
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(nodes)
    bmin = np.stack([n[0] for n in nodes]).astype(np.float32)
    bmax = np.stack([n[1] for n in nodes]).astype(np.float32)
    first = np.array([n[2] for n in nodes], np.int32)
    count = np.array([n[3] for n in nodes], np.int32)
    escape = np.array([n[4] if n[4] >= 0 else i + 1
                       for i, n in enumerate(nodes)], np.int32)
    # Leaves' escape is the next node in DFS order; the last node escapes
    # to m (done sentinel).
    return (bmin, bmax, first, count, escape), order


def build_over_triangles(tris: Triangles, leaf_size=LEAF_SIZE,
                         split=None):
    """Build a BVH over a Triangles set; returns (FlatBVH, reordered
    Triangles)."""
    va = np.asarray(tris.va)
    vb = va + np.asarray(tris.e_ab)
    vc = va + np.asarray(tris.e_ac)
    bmin = np.minimum(np.minimum(va, vb), vc)
    bmax = np.maximum(np.maximum(va, vb), vc)
    cent = (va + vb + vc) / 3.0
    (nb_min, nb_max, first, count, escape), order = build(
        cent, bmin, bmax, leaf_size, split=split)

    # Host-side reorder + host FlatBVH: mesh builds stay NumPy until the
    # registry/scene build converts once (see Triangles.from_soup).
    reordered = jax.tree.map(lambda x: np.asarray(x)[order], tris)
    bvh = FlatBVH(bmin=nb_min.astype(np.float32),
                  bmax=nb_max.astype(np.float32),
                  first=first, count=count, escape=escape)
    return bvh, reordered


def _slab_test(bmin, bmax, o, inv_d, t_min, t_max):
    """AABB slab intersection (reference: geom.rs:218-247), batched.

    bmin/bmax/o/inv_d: (N,3); returns (N,) bool.
    """
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    near = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    far = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    return near <= far



def _device(tree):
    """Promote host (NumPy-leaf) meshes/BVHs to device arrays.

    Production scenes convert once at SceneBuilder.build(); this keeps
    direct/test use of host-built structures working (a NumPy leaf
    cannot be gather-indexed by a tracer).  No-op on device arrays.
    """
    return jax.tree.map(jnp.asarray, tree)

def intersect_bvh_tris(tris: Triangles, bvh: FlatBVH, o, d, t_min, t_max):
    """Closest triangle hit via stackless BVH traversal.

    Returns (t, index, u, v) per ray like triangles.nearest_hit.
    """
    tris, bvh = _device(tris), _device(bvh)
    n = o.shape[0]
    m = bvh.n_nodes
    inv_d = 1.0 / d
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    od = jnp.sum(o * d, axis=-1)  # varying-typed seed for carry inits
    state = (
        jnp.zeros_like(od, dtype=jnp.int32),   # node index
        jnp.full_like(od, INF),                # best t
        jnp.zeros_like(od, dtype=jnp.int32),   # best triangle
        jnp.zeros_like(od),                    # best u
        jnp.zeros_like(od),                    # best v
    )

    def cond(state):
        node, *_ = state
        return jnp.any(node < m)

    def step(state):
        node, best_t, best_i, best_u, best_v = state
        active = node < m
        ni = jnp.minimum(node, m - 1)

        hit_box = _slab_test(bvh.bmin[ni], bvh.bmax[ni], o, inv_d,
                             t_min, jnp.minimum(best_t, t_max)) & active
        count = bvh.count[ni]
        first = bvh.first[ni]
        is_leaf = count > 0

        # Leaf: test up to LEAF_SIZE contiguous triangles (masked).
        do_test = hit_box & is_leaf
        for j in range(LEAF_SIZE):
            ti = jnp.minimum(first + j, tris.count - 1)
            valid = do_test & (j < count)
            ab = tris.e_ab[ti]
            ac = tris.e_ac[ti]
            va = tris.va[ti]
            p = jnp.cross(d, ac)
            det = jnp.sum(ab * p, axis=-1)
            det_ok = jnp.abs(det) >= DET_EPS
            inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
            tv = o - va
            u = jnp.sum(tv * p, axis=-1) * inv_det
            q = jnp.cross(tv, ab)
            v = jnp.sum(d * q, axis=-1) * inv_det
            t = jnp.sum(ac * q, axis=-1) * inv_det
            # Deterministic tie rule: strictly closer wins; equal t ->
            # lower primitive index wins.  Matches the reference's
            # strict t_max shrink (geom.rs:188-195 passes closest_so_far
            # as t_max and roots are rejected at t_max <= root,
            # geom.rs:64-75), and makes the winner independent of
            # traversal order (the brute scans find the same one).
            ok = (valid
                  & det_ok
                  & (u >= 0.0) & (u <= 1.0)
                  & (v >= 0.0) & (u + v <= 1.0)
                  & (t >= t_min) & (t <= t_max)
                  & ((t < best_t) | ((t == best_t) & (ti < best_i))))
            best_i = jnp.where(ok, ti, best_i)
            best_u = jnp.where(ok, u, best_u)
            best_v = jnp.where(ok, v, best_v)
            best_t = jnp.where(ok, t, best_t)

        # Advance: into the subtree on internal hit, else skip it.
        next_node = jnp.where(hit_box & ~is_leaf, ni + 1, bvh.escape[ni])
        node = jnp.where(active, next_node, node)
        return node, best_t, best_i, best_u, best_v

    _, best_t, best_i, best_u, best_v = jax.lax.while_loop(
        cond, step, state)
    return best_t, best_i, best_u, best_v


def intersect_bvh(tris: Triangles, bvh: FlatBVH, o, d, t_min, t_max,
                  scene=None):
    """Hits-producing wrapper used by Scene.intersect."""
    from .triangles import make_hits

    tris, bvh = _device(tris), _device(bvh)
    t, i, u, v = intersect_bvh_tris(tris, bvh, o, d, t_min, t_max)
    return make_hits(tris, o, d, t, i, u, v)


# ---------------------------------------------------------------------------
# Sphere BVH: same flat layout, leaves test the quadratic instead of MT.
# The reference's world-level BVH treats spheres as just another
# `Box<dyn Intersect>` leaf (geom.rs:109-162); here sphere sets of any
# size get their own traversal with the root-selection of geom.rs:64-75.
# ---------------------------------------------------------------------------

def build_over_spheres(spheres, leaf_size=LEAF_SIZE):
    """Build a BVH over a Spheres set; returns (FlatBVH, reordered
    Spheres)."""
    c = np.asarray(spheres.center)
    r = np.asarray(spheres.radius)[:, None]
    (nb_min, nb_max, first, count, escape), order = build(
        c, c - r, c + r, leaf_size)
    perm = jnp.asarray(order)
    reordered = jax.tree.map(lambda x: x[perm], spheres)
    bvh = FlatBVH(bmin=jnp.asarray(nb_min), bmax=jnp.asarray(nb_max),
                  first=jnp.asarray(first), count=jnp.asarray(count),
                  escape=jnp.asarray(escape))
    return bvh, reordered


def intersect_bvh_spheres(spheres, bvh: FlatBVH, o, d, t_min, t_max):
    """Closest sphere hit via stackless traversal; returns Hits."""
    from .spheres import make_hits

    spheres, bvh = _device(spheres), _device(bvh)
    n = o.shape[0]
    m = bvh.n_nodes
    inv_d = 1.0 / d
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    a = jnp.sum(d * d, axis=-1)

    od = jnp.sum(o * d, axis=-1)
    state = (
        jnp.zeros_like(od, dtype=jnp.int32),
        jnp.full_like(od, INF),
        jnp.zeros_like(od, dtype=jnp.int32),
    )

    def cond(state):
        return jnp.any(state[0] < m)

    def step(state):
        node, best_t, best_i = state
        active = node < m
        ni = jnp.minimum(node, m - 1)
        hit_box = _slab_test(bvh.bmin[ni], bvh.bmax[ni], o, inv_d,
                             t_min, jnp.minimum(best_t, t_max)) & active
        count = bvh.count[ni]
        first = bvh.first[ni]
        is_leaf = count > 0
        do_test = hit_box & is_leaf

        for j in range(LEAF_SIZE):
            si = jnp.minimum(first + j, spheres.count - 1)
            valid = do_test & (j < count)
            oc = o - spheres.center[si]
            half_b = jnp.sum(oc * d, axis=-1)
            cterm = jnp.sum(oc * oc, axis=-1) - spheres.radius[si] ** 2
            disc = half_b * half_b - a * cterm
            # where-before-sqrt: keep backward passes NaN-free.
            sq = jnp.sqrt(jnp.where(disc >= 0.0,
                                    jnp.maximum(disc, 0.0), 1.0))
            inv_a = 1.0 / a
            root0 = (-half_b - sq) * inv_a
            root1 = (-half_b + sq) * inv_a
            lim = jnp.minimum(best_t, t_max)
            ok = valid & (disc >= 0.0)
            ok0 = ok & (root0 >= t_min) & (root0 <= lim)
            ok1 = ok & (root1 >= t_min) & (root1 <= lim)
            root = jnp.where(ok0, root0, jnp.where(ok1, root1, INF))
            # Tie rule: equal root -> lower sphere index (see the
            # triangle traversal above).  root==INF ties are inert
            # (best_i starts at 0, si >= 0).
            better = (root < best_t) | ((root == best_t) & (si < best_i))
            best_t = jnp.where(better, root, best_t)
            best_i = jnp.where(better, si, best_i)

        next_node = jnp.where(hit_box & ~is_leaf, ni + 1, bvh.escape[ni])
        node = jnp.where(active, next_node, node)
        return node, best_t, best_i

    _, best_t, best_i = jax.lax.while_loop(cond, step, state)
    return make_hits(spheres, o, d, best_t, best_i)
