"""Instanced brute-force TLAS intersection: the traversal's oracle.

Tests candidate triangles densely with per-lane predication: no
traversal, cost set by geometry size alone.  Reached with
MRT_TLAS_KERNEL=brute; tests compare the two-level traversal
(geometry/instance.py) against it.

Shape: a `lax.while_loop` over *candidate rounds*.  Each lane walks
its instances in (entry-t, index) order — candidates are re-derived
each round from slab entry distances against per-instance world AABBs
(pure elementwise; the lexicographic cursor (last_e, last_i) replaces
any per-lane mask) — and early-outs once the next entry exceeds its
best hit.  A round fetches the lane's inverse transform + triangle
range with one row lookup, warps the ray to object space (same
arithmetic as the two-level traversal), and scans ALL concatenated
triangles in chunks with ownership predication (global index within
the lane's mesh range).  The deterministic (t, instance, triangle) tie
rule makes the winner identical to the two-level traversal's.

Matches the closest-hit semantics of the reference's recursive
Instance intersect (reference: src/geom.rs:275-425) exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .hit import Hits, INF
from .triangles import DET_EPS
from .instance import HIGHEST, TLAS, expand_winner

# Triangles per inner-scan chunk; instances per selection chunk.
TRI_CHUNK = 64
INST_CHUNK = 16

def wants_brute(tlas: TLAS) -> bool:
    import os
    return os.environ.get("MRT_TLAS_KERNEL", "") == "brute"


def _pad_to(x, n):
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad)


def intersect_tlas_brute(tlas: TLAS, o, d, t_min, t_max) -> Hits:
    """Closest hit over all instances; o, d: (N,3).  t_min/t_max may
    be scalars or (N,) (the alpha re-cast path passes vector t_min)."""
    n = o.shape[0]
    n_inst = tlas.transform.shape[0]
    tris = tlas.tris
    t_cnt = tris.count

    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    inv_d = 1.0 / d

    # ---- per-instance world AABBs: the exact boxes the TLAS leaves
    # were built from (instance.py build, stored as w_min/w_max) so
    # this path culls identically to the two-level traversal — a
    # device-side recompute can differ by ulps and flip a grazing
    # cull.  Fallback recompute only for pre-existing pytrees.
    if tlas.w_min is not None:
        w_min, w_max = tlas.w_min, tlas.w_max
    else:
        root_bmin = tlas.bmin[tlas.blas_root]                # (I,3)
        root_bmax = tlas.bmax[tlas.blas_root]
        combos = jnp.asarray(
            [[float(x), float(y), float(z)]
             for x in (0, 1) for y in (0, 1) for z in (0, 1)],
            jnp.float32)
        corners = (root_bmin[:, None, :] * (1.0 - combos[None])
                   + root_bmax[:, None, :] * combos[None])   # (I,8,3)
        fwd = tlas.transform
        wc = (jnp.einsum("iab,icb->ica", fwd[:, :3, :3], corners,
                         precision=HIGHEST)
              + fwd[:, None, :3, 3])
        w_min = wc.min(axis=1)                               # (I,3)
        w_max = wc.max(axis=1)

    # Instance row table for the per-round fetch: inverse transform
    # (12) + triangle range (2).  Range ints are < 2^24 so the f32
    # columns are exact.
    inst_table = jnp.concatenate(
        [tlas.inv_transform[:, :3, :].reshape(n_inst, 12),
         tlas.tri_first.astype(jnp.float32)[:, None],
         tlas.tri_count.astype(jnp.float32)[:, None]], axis=-1)

    # Padded selection chunks (lane-uniform chunking over instances).
    ic = min(INST_CHUNK, max(8, n_inst))
    i_pad = ((n_inst + ic - 1) // ic) * ic
    sel_bmin = _pad_to(w_min, i_pad).reshape(-1, ic, 3)
    sel_bmax = _pad_to(w_max, i_pad).reshape(-1, ic, 3)
    sel_base = jnp.arange(i_pad // ic, dtype=jnp.int32) * ic

    # Padded triangle chunks (degenerate padding is rejected by det=0).
    tc = min(TRI_CHUNK, max(8, t_cnt))
    t_pad = ((t_cnt + tc - 1) // tc) * tc
    cva = _pad_to(tris.va, t_pad).reshape(-1, tc, 3)
    cab = _pad_to(tris.e_ab, t_pad).reshape(-1, tc, 3)
    cac = _pad_to(tris.e_ac, t_pad).reshape(-1, tc, 3)
    tri_base = jnp.arange(t_pad // tc, dtype=jnp.int32) * tc

    def select_next(last_e, last_i, lim):
        """Per-lane nearest untested instance: min (entry, index) key
        lexicographically above (last_e, last_i) with entry <= lim."""
        def body(carry, chunk_in):
            cand_e, cand_i = carry
            bmin_c, bmax_c, b0 = chunk_in
            t0 = (bmin_c[:, None, :] - o[None]) * inv_d[None]
            t1 = (bmax_c[:, None, :] - o[None]) * inv_d[None]
            lo = jnp.minimum(t0, t1)
            hi = jnp.maximum(t0, t1)
            near = jnp.maximum(jnp.max(lo, axis=-1), t_min[None])
            far = jnp.minimum(jnp.min(hi, axis=-1), lim[None])
            idx = b0 + jnp.arange(ic, dtype=jnp.int32)         # (C,)
            after = ((near > last_e[None])
                     | ((near == last_e[None])
                        & (idx[:, None] > last_i[None])))
            ok = (near <= far) & after & (idx[:, None] < n_inst)
            e = jnp.where(ok, near, INF)
            sel = jnp.argmin(e, axis=0)                        # (N,)
            ce = jnp.take_along_axis(e, sel[None], axis=0)[0]
            ci = sel.astype(jnp.int32) + b0
            # Chunks ascend in index, so a strictly-smaller entry is
            # required to replace an earlier chunk's candidate (equal
            # entries keep the lower instance index).
            better = ce < cand_e
            return (jnp.where(better, ce, cand_e),
                    jnp.where(better, ci, cand_i)), None

        od = jnp.sum(o * d, axis=-1)
        init = (jnp.full_like(od, INF),
                jnp.full_like(od, -1, dtype=jnp.int32))
        (cand_e, cand_i), _ = jax.lax.scan(
            body, init, (sel_bmin, sel_bmax, sel_base))
        return cand_e, jnp.where(jnp.isfinite(cand_e), cand_i, -1)

    def round_body(st):
        (cand_e, cand_i, best_t, best_inst, best_tri, best_u,
         best_v) = st
        active = cand_i >= 0

        rows = inst_table[jnp.clip(cand_i, 0, None)]
        inv = rows[:, :12].reshape(-1, 3, 4)
        # Same object-space warp arithmetic as the two-level traversal
        # (instance.intersect_tlas) so winners match bit-exactly.
        o_l = (jnp.einsum("nij,nj->ni", inv[:, :, :3], o,
                          precision=HIGHEST)
               + inv[:, :, 3])
        d_l = jnp.einsum("nij,nj->ni", inv[:, :, :3], d,
                         precision=HIGHEST)
        first_l = jnp.round(rows[:, 12]).astype(jnp.int32)
        end_l = first_l + jnp.round(rows[:, 13]).astype(jnp.int32)

        def tri_body(carry, chunk_in):
            bt, binst, btri, bu, bv = carry
            va_c, ab_c, ac_c, b0 = chunk_in
            ti = b0 + jnp.arange(tc, dtype=jnp.int32)          # (C,)
            own = ((ti[:, None] >= first_l[None])
                   & (ti[:, None] < end_l[None])
                   & active[None])
            # Möller–Trumbore, the exact expression sequence of the
            # two-level BLAS loop.
            p = jnp.cross(d_l[None], ac_c[:, None, :])
            det = jnp.sum(ab_c[:, None, :] * p, axis=-1)
            det_ok = jnp.abs(det) >= DET_EPS
            inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
            tv = o_l[None] - va_c[:, None, :]
            u = jnp.sum(tv * p, axis=-1) * inv_det
            q = jnp.cross(tv, ab_c[:, None, :])
            v = jnp.sum(d_l[None] * q, axis=-1) * inv_det
            t = jnp.sum(ac_c[:, None, :] * q, axis=-1) * inv_det
            ok = (own & det_ok
                  & (u >= 0.0) & (u <= 1.0)
                  & (v >= 0.0) & (u + v <= 1.0)
                  & (t >= t_min[None]) & (t <= t_max[None]))
            t = jnp.where(ok, t, INF)
            sel = jnp.argmin(t, axis=0)                        # (N,)
            ct = jnp.take_along_axis(t, sel[None], axis=0)[0]
            ci = sel.astype(jnp.int32) + b0
            cu = jnp.take_along_axis(u, sel[None], axis=0)[0]
            cv = jnp.take_along_axis(v, sel[None], axis=0)[0]
            # Deterministic tie rule: strictly closer wins, equal t
            # falls back to lower (instance, triangle) — identical to
            # the two-level traversal.
            better = ((ct < bt)
                      | ((ct == bt) & jnp.isfinite(ct)
                         & ((cand_i < binst)
                            | ((cand_i == binst) & (ci < btri)))))
            return (jnp.where(better, ct, bt),
                    jnp.where(better, cand_i, binst),
                    jnp.where(better, ci, btri),
                    jnp.where(better, cu, bu),
                    jnp.where(better, cv, bv)), None

        (best_t, best_inst, best_tri, best_u, best_v), _ = jax.lax.scan(
            tri_body, (best_t, best_inst, best_tri, best_u, best_v),
            (cva, cab, cac, tri_base))

        lim = jnp.minimum(best_t, t_max)
        next_e, next_i = select_next(cand_e, cand_i, lim)
        return (next_e, next_i, best_t, best_inst, best_tri, best_u,
                best_v)

    od = jnp.sum(o * d, axis=-1)  # varying-typed seed for carry inits
    i32 = lambda v: jnp.full_like(od, v, dtype=jnp.int32)
    first_e, first_i = select_next(jnp.full_like(od, -INF), i32(-1),
                                   t_max)
    state = (first_e, first_i,
             jnp.full_like(od, INF),   # best t
             i32(-1),                  # best instance
             i32(0),                   # best triangle
             jnp.zeros_like(od),       # best u
             jnp.zeros_like(od))       # best v

    state = jax.lax.while_loop(
        lambda st: jnp.any(st[1] >= 0), round_body, state)
    (_, _, best_t, best_inst, best_tri, best_u, best_v) = state
    return expand_winner(tlas, o, d, best_t, best_inst, best_tri,
                         best_u, best_v)
