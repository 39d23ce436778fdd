"""CPU-reference (NumPy) oracle: brute-force intersection and a recursive
median/SAH-binned BVH with skip-link flattening.

This mirrors the reference's CPU builder + compute-shader traversal pair
(Source/BVHBuilder.cpp ``BVHBuilder::build`` and
Source/Shaders/RayTracedShadows.comp ``castShadowRay`` [RECALL; reference
mount empty at survey time]) but exists here as the *golden oracle*: every
JAX result (and, through the XLA walk, the CUDA kernel) is validated against it (SURVEY.md §4). It is deliberately
simple, scalar, and independent of the JAX code paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..types import Mesh

INVALID = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Scalar primitives (also the spec for the vectorized and CUDA versions)
# ---------------------------------------------------------------------------

def moller_trumbore(orig, d, v0, e1, e2, t_min=0.0, t_max=np.inf,
                    eps=1e-9) -> float:
    """Scalar Möller–Trumbore; returns hit t or +inf.

    Watertight enough for shadow tests; backface hits count (shadows are
    two-sided, as in the reference's any-hit compute path [RECALL]).
    """
    pvec = np.cross(d, e2)
    det = float(np.dot(e1, pvec))
    if abs(det) < eps:
        return np.inf
    inv_det = 1.0 / det
    tvec = orig - v0
    u = float(np.dot(tvec, pvec)) * inv_det
    if u < 0.0 or u > 1.0:
        return np.inf
    qvec = np.cross(tvec, e1)
    v = float(np.dot(d, qvec)) * inv_det
    if v < 0.0 or u + v > 1.0:
        return np.inf
    t = float(np.dot(e2, qvec)) * inv_det
    if t_min < t < t_max:
        return t
    return np.inf


def ray_aabb(orig, inv_d, bmin, bmax, t_min=0.0, t_max=np.inf) -> bool:
    """Scalar slab test. inv_d may contain +/-inf (axis-parallel rays)."""
    t0 = (bmin - orig) * inv_d
    t1 = (bmax - orig) * inv_d
    # min/max with NaN suppression (0 * inf): replace NaN by +/-inf extremes
    lo = np.minimum(t0, t1)
    hi = np.maximum(t0, t1)
    lo = np.where(np.isnan(lo), -np.inf, lo)
    hi = np.where(np.isnan(hi), np.inf, hi)
    enter = max(lo.max(), t_min)
    exit_ = min(hi.min(), t_max)
    return bool(enter <= exit_)


# ---------------------------------------------------------------------------
# Brute force
# ---------------------------------------------------------------------------

def triangle_data(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(v0, e1, e2) per triangle — the baked leaf layout of the reference."""
    v = np.asarray(mesh.vertices, np.float64)
    idx = np.asarray(mesh.indices)
    v0 = v[idx[:, 0]]
    e1 = v[idx[:, 1]] - v0
    e2 = v[idx[:, 2]] - v0
    return v0, e1, e2


def brute_force_closest(mesh: Mesh, origins: np.ndarray, dirs: np.ndarray,
                        t_min: float = 0.0, t_max=np.inf
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized-over-triangles brute force. Returns (t [N], tri_id [N]).

    t = +inf, tri_id = -1 where there is no hit. ``t_max`` may be a
    scalar or a per-ray array [N] (e.g. shadow scene-exit distances).
    """
    v0, e1, e2 = triangle_data(mesh)
    origins = np.asarray(origins, np.float64).reshape(-1, 3)
    dirs = np.asarray(dirs, np.float64).reshape(-1, 3)
    n = origins.shape[0]
    t_max = np.broadcast_to(np.asarray(t_max, np.float64), (n,))
    out_t = np.full(n, np.inf)
    out_id = np.full(n, -1, np.int64)
    # Chunk rays so the [rays, tris] intermediates stay bounded.
    chunk = max(1, min(n, 8_000_000 // max(len(v0), 1)))
    for lo in range(0, n, chunk):
        o = origins[lo:lo + chunk]          # [R, 3]
        d = dirs[lo:lo + chunk]
        pvec = np.cross(d[:, None, :], e2[None, :, :])       # [R, T, 3]
        det = np.einsum("tj,rtj->rt", e1, pvec)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_det = np.where(np.abs(det) < 1e-12, np.nan, 1.0 / det)
            tvec = o[:, None, :] - v0[None, :, :]
            u = np.einsum("rtj,rtj->rt", tvec, pvec) * inv_det
            qvec = np.cross(tvec, e1[None, :, :])
            vv = np.einsum("rj,rtj->rt", d, qvec) * inv_det
            t = np.einsum("tj,rtj->rt", e2, qvec) * inv_det
        ok = ((u >= 0) & (u <= 1) & (vv >= 0) & (u + vv <= 1)
              & (t > t_min) & (t < t_max[lo:lo + chunk, None])
              & np.isfinite(t))
        tt = np.where(ok, t, np.inf)
        j = np.argmin(tt, axis=1)
        rows = np.arange(len(o))
        best = tt[rows, j]
        hit = np.isfinite(best)
        out_t[lo:lo + chunk][hit] = best[hit]
        out_id[lo:lo + chunk][hit] = j[hit]
    return out_t, out_id


def brute_force_any(mesh: Mesh, origins: np.ndarray, dirs: np.ndarray,
                    t_min: float = 0.0, t_max: float = np.inf) -> np.ndarray:
    """Any-hit occlusion query. Returns bool[N] (True = occluded)."""
    t, _ = brute_force_closest(mesh, origins, dirs, t_min, t_max)
    return np.isfinite(t)


# ---------------------------------------------------------------------------
# Recursive CPU BVH (median / SAH-binned) with skip-link flattening
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CpuBVH:
    """Flattened depth-first BVH with skip links, as the reference uploads to
    the GPU (BVHNode { bboxMin, prim, bboxMax, next } [RECALL approximation]).

    bb_min, bb_max : f32[num_nodes, 3]
    prim_start     : i32[num_nodes]  (first triangle for leaves, -1 interior)
    prim_count     : i32[num_nodes]  (0 for interior nodes)
    skip           : i32[num_nodes]  (next node if box missed / leaf done;
                                      == num_nodes at the end -> terminate)
    tri_order      : i32[T] triangle permutation (leaves index into this)
    """

    bb_min: np.ndarray
    bb_max: np.ndarray
    prim_start: np.ndarray
    prim_count: np.ndarray
    skip: np.ndarray
    tri_order: np.ndarray

    @property
    def num_nodes(self) -> int:
        return len(self.bb_min)


def build_cpu_bvh(mesh: Mesh, leaf_size: int = 4, method: str = "median") -> CpuBVH:
    v0, e1, e2 = triangle_data(mesh)
    tri_min = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    tri_max = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    centroids = (tri_min + tri_max) * 0.5
    n = len(v0)
    order = np.arange(n)

    nodes = []  # (bb_min, bb_max, prim_start, prim_count, subtree_size_slot)

    def emit(lo: int, hi: int) -> int:
        """Build subtree over order[lo:hi]; returns node index."""
        my = len(nodes)
        bmin = tri_min[order[lo:hi]].min(axis=0)
        bmax = tri_max[order[lo:hi]].max(axis=0)
        if hi - lo <= leaf_size:
            nodes.append([bmin, bmax, lo, hi - lo])
            return my
        cen = centroids[order[lo:hi]]
        ext = cen.max(axis=0) - cen.min(axis=0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            nodes.append([bmin, bmax, lo, hi - lo])  # degenerate: leaf
            return my
        if method == "median":
            local = np.argsort(cen[:, axis], kind="stable")
            mid = (hi - lo) // 2
        else:  # SAH binned
            nb = 16
            rel = (cen[:, axis] - cen[:, axis].min()) / ext[axis]
            bins = np.minimum((rel * nb).astype(np.int64), nb - 1)
            local = np.argsort(bins, kind="stable")
            counts = np.bincount(bins, minlength=nb)
            # cost of split after bin k ~ NL*areaL + NR*areaR using AABBs
            best_cost, best_k = np.inf, None
            sorted_ids = order[lo:hi][local]
            csum = np.cumsum(counts)
            for k in range(1, nb):
                nl = csum[k - 1]
                nr = (hi - lo) - nl
                if nl == 0 or nr == 0:
                    continue
                lids = sorted_ids[:nl]
                rids = sorted_ids[nl:]
                dl = tri_max[lids].max(0) - tri_min[lids].min(0)
                dr = tri_max[rids].max(0) - tri_min[rids].min(0)
                sa = lambda d: d[0] * d[1] + d[1] * d[2] + d[2] * d[0]
                cost = nl * sa(dl) + nr * sa(dr)
                if cost < best_cost:
                    best_cost, best_k = cost, int(nl)
            mid = best_k if best_k is not None else (hi - lo) // 2
        order[lo:hi] = order[lo:hi][local]
        nodes.append([bmin, bmax, -1, 0])
        emit(lo, lo + mid)
        emit(lo + mid, hi)
        return my

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 100))
    try:
        emit(0, n)
    finally:
        sys.setrecursionlimit(old_limit)

    num = len(nodes)
    bb_min = np.stack([nd[0] for nd in nodes]).astype(np.float32)
    bb_max = np.stack([nd[1] for nd in nodes]).astype(np.float32)
    prim_start = np.array([nd[2] for nd in nodes], np.int32)
    prim_count = np.array([nd[3] for nd in nodes], np.int32)

    # Skip links: for depth-first layout, node i's subtree occupies
    # [i, subtree_end). skip[i] = subtree_end. Compute via a stack walk.
    skip = np.empty(num, np.int32)

    def fill_skip(i: int) -> int:
        if prim_count[i] > 0:
            skip[i] = i + 1
            return i + 1
        end_left = fill_skip(i + 1)
        end = fill_skip(end_left)
        skip[i] = end
        return end

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 4 * n + 100))
    fill_skip(0)

    return CpuBVH(bb_min=bb_min, bb_max=bb_max, prim_start=prim_start,
                  prim_count=prim_count, skip=skip,
                  tri_order=order.astype(np.int32))


def cpu_bvh_traverse(bvh: CpuBVH, mesh: Mesh, origins, dirs,
                     t_min: float = 0.0, t_max: float = np.inf,
                     any_hit: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Stackless skip-link traversal, scalar per ray — the oracle's mirror of
    the reference compute shader's while loop (SURVEY.md §3.4).

    Returns (t [N], tri_id [N]) with t=+inf / id=-1 on miss. For any_hit the
    returned t is *a* hit (not necessarily the closest).
    """
    v0, e1, e2 = triangle_data(mesh)
    origins = np.asarray(origins, np.float64).reshape(-1, 3)
    dirs = np.asarray(dirs, np.float64).reshape(-1, 3)
    nrays = origins.shape[0]
    out_t = np.full(nrays, np.inf)
    out_id = np.full(nrays, -1, np.int64)
    num = bvh.num_nodes
    for r in range(nrays):
        o, d = origins[r], dirs[r]
        with np.errstate(divide="ignore"):
            inv_d = 1.0 / d
        node = 0
        best_t, best_id = t_max, -1
        while node < num:
            if ray_aabb(o, inv_d, bvh.bb_min[node], bvh.bb_max[node],
                        t_min, best_t):
                cnt = bvh.prim_count[node]
                if cnt > 0:
                    for k in range(cnt):
                        tri = int(bvh.tri_order[bvh.prim_start[node] + k])
                        t = moller_trumbore(o, d, v0[tri], e1[tri], e2[tri],
                                            t_min, best_t)
                        if t < best_t:
                            best_t, best_id = t, tri
                    if any_hit and best_id >= 0:
                        break
                    node = int(bvh.skip[node])
                else:
                    node = node + 1
            else:
                node = int(bvh.skip[node])
        if best_id >= 0:
            out_t[r] = best_t
            out_id[r] = best_id
    return out_t, out_id
