"""Deformation-exact SBVH refit via static barycentric clip geometry.

The native SBVH builder (native/tpurt_native.cpp) duplicates triangle
references across spatial splits and stores CLIPPED boxes — that clipping
is why it traces ~2x faster than object-split SAH on Sponza-class scenes.
A classic refit (full-triangle leaf boxes + bottom-up union) forfeits the
clipping: every duplicated reference re-inflates to the whole triangle
and the spatial-split advantage dissolves.

The fix: a clipped region is STATIC IN BARYCENTRIC SPACE.
Each leaf's clip region is ``triangle ∩ leaf_box`` (a convex polygon of
<= 9 vertices); a vertex with fixed barycentric coordinates moves
affinely with the deformed triangle corners, so the polygon's
deformed-world AABB is an exact, conservative bound of the deformed clip
region — computed with pure elementwise math, no re-clipping, no
gathers. Precompute (host, once per scene): the polygon vertex set in
barycentric coords per leaf slot. Per frame (device, fused): evaluate
the <= 9 world points per slot, reduce to leaf boxes, RMQ the internal
boxes, reassemble the wide rows from the static collapse plan.

Correctness: spatial splits PARTITION each triangle's surface among its
references, and barycentric containment is deformation-invariant, so the
union of the refit reference boxes always covers the whole deformed
triangle — any-hit and closest-hit traversal stay exact (the leaf
triangle test itself is the full Möller–Trumbore, never clipped).

Reference role: the reference has no refit at all (BVHBuilder.cpp
rebuilds on the host [RECALL; mount empty]); BASELINE config 4 makes
refit first-class. This module makes refit preserve the static accel's
full quality instead of degrading toward the Morton tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .lbvh import LBVH, _assemble_node_boxes
from .wide import WideBVH, make_wide_plan, widen_from_plan

MAX_PTS = 9   # triangle clipped by a box: at most 9 polygon vertices


class ClipRefitPlan(NamedTuple):
    """Static per-scene refit plan for an SBVH topology (a pytree).

    bary  : f32[S, MAX_PTS, 2] — (b1, b2) barycentric coords of the clip
            polygon's vertices per leaf slot, padded by repeating a valid
            vertex (padding never widens the AABB).
    plan  : wide-collapse plan (make_wide_plan) for the same topology.
    slack : f32[S] — per-slot Chebyshev-barycentric radius covering every
            candidate vertex the compaction dropped (dedup merges + top_k
            crowding); refit_sbvh pads the slot box by
            ``slack * (|e1| + |e2|)`` so the refit AABB stays conservative
            even when a distinct hull vertex was merged away. Zero (the
            common case) when nothing was dropped.
    """

    bary: Any
    plan: Any
    slack: Any = None


def _leaf_boxes_np(lbvh: LBVH) -> Tuple[np.ndarray, np.ndarray]:
    """Per-leaf stored (clipped) boxes out of nodes_box, host-side."""
    child = np.asarray(lbvh.nodes_child)
    box = np.asarray(lbvh.nodes_box)
    nl = lbvh.num_leaves
    lmin = np.full((nl, 3), np.inf, np.float32)
    lmax = np.full((nl, 3), -np.inf, np.float32)
    for side, lo in ((0, 0), (1, 6)):
        ref = child[:, side]
        m = ref < 0
        lmin[-ref[m] - 1] = box[m, lo:lo + 3]
        lmax[-ref[m] - 1] = box[m, lo + 3:lo + 6]
    return lmin, lmax


def clip_slots_bary(lbvh: LBVH, rel_eps: float = 1e-5) -> np.ndarray:
    """f32[S, MAX_PTS, 2]: barycentric vertices of (triangle ∩ leaf box)
    per leaf slot. Host NumPy, fully vectorized over slots: the vertex
    set is (triangle corners inside the box) ∪ (triangle-edge × box-face
    crossings) ∪ (box-edge × triangle-plane crossings inside the
    triangle) — the convex hull of those IS the clip polygon, and an AABB
    over vertices needs no ordering."""
    v0 = np.asarray(lbvh.tri_v0, np.float64)
    e1 = np.asarray(lbvh.tri_e1, np.float64)
    e2 = np.asarray(lbvh.tri_e2, np.float64)
    s = v0.shape[0]
    k = lbvh.leaf_size
    lmin, lmax = _leaf_boxes_np(lbvh)
    bmin = np.repeat(lmin.astype(np.float64), k, axis=0)   # [S, 3]
    bmax = np.repeat(lmax.astype(np.float64), k, axis=0)
    eps = rel_eps * np.maximum(np.max(bmax - bmin, axis=1, keepdims=True),
                               1e-12)                      # [S, 1]

    cand_b = []   # list of [S, 2]
    cand_ok = []  # list of [S]

    def world(b1, b2):
        return v0 + b1[:, None] * e1 + b2[:, None] * e2

    def inside_box(p, skip_axis=None):
        ok = np.ones(s, bool)
        for a in range(3):
            if a == skip_axis:
                continue
            ok &= (p[:, a] >= bmin[:, a] - eps[:, 0]) \
                & (p[:, a] <= bmax[:, a] + eps[:, 0])
        return ok

    # (a) triangle corners inside the box
    corners = [(np.zeros(s), np.zeros(s)), (np.ones(s), np.zeros(s)),
               (np.zeros(s), np.ones(s))]
    for b1, b2 in corners:
        p = world(b1, b2)
        cand_b.append(np.stack([b1, b2], axis=1))
        cand_ok.append(inside_box(p))

    # (b) triangle edges x box face planes
    edges = [((np.zeros(s), np.zeros(s)), (np.ones(s), np.zeros(s))),
             ((np.zeros(s), np.zeros(s)), (np.zeros(s), np.ones(s))),
             ((np.ones(s), np.zeros(s)), (np.zeros(s), np.ones(s)))]
    for (pb1, pb2), (qb1, qb2) in edges:
        p = world(pb1, pb2)
        q = world(qb1, qb2)
        d = q - p
        for a in range(3):
            for c in (bmin[:, a], bmax[:, a]):
                da = d[:, a]
                safe = np.abs(da) > 1e-300
                t = np.where(safe, (c - p[:, a]) / np.where(safe, da, 1.0),
                             -1.0)
                ok = safe & (t >= -1e-9) & (t <= 1 + 1e-9)
                t = np.clip(t, 0.0, 1.0)
                b1 = pb1 + t * (qb1 - pb1)
                b2 = pb2 + t * (qb2 - pb2)
                x = world(b1, b2)
                ok &= inside_box(x, skip_axis=a)
                cand_b.append(np.stack([b1, b2], axis=1))
                cand_ok.append(ok)

    # (c) box edges x triangle plane: fix axes (a, b) at chosen faces,
    # solve the 2x2 system for (b1, b2).
    for a in range(3):
        for b in range(a + 1, 3):
            d_axis = 3 - a - b
            for va in (bmin[:, a], bmax[:, a]):
                for vb in (bmin[:, b], bmax[:, b]):
                    # e1[a] b1 + e2[a] b2 = va - v0[a]; same for b.
                    m00, m01 = e1[:, a], e2[:, a]
                    m10, m11 = e1[:, b], e2[:, b]
                    det = m00 * m11 - m01 * m10
                    safe = np.abs(det) > 1e-300
                    inv = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
                    ra = va - v0[:, a]
                    rb = vb - v0[:, b]
                    b1 = (m11 * ra - m01 * rb) * inv
                    b2 = (m00 * rb - m10 * ra) * inv
                    ok = safe & (b1 >= -1e-9) & (b2 >= -1e-9) \
                        & (b1 + b2 <= 1 + 1e-9)
                    p = world(b1, b2)
                    ok &= (p[:, d_axis] >= bmin[:, d_axis] - eps[:, 0]) \
                        & (p[:, d_axis] <= bmax[:, d_axis] + eps[:, 0])
                    cand_b.append(np.stack([b1, b2], axis=1))
                    cand_ok.append(ok)

    cb = np.stack(cand_b, axis=1)            # [S, C, 2]
    ok = np.stack(cand_ok, axis=1)           # [S, C]

    # Degenerate slots (numerically empty intersection): fall back to the
    # full triangle — conservative, never wrong.
    none = ~ok.any(axis=1)
    if none.any():
        cb[none, 0] = (0.0, 0.0)
        cb[none, 1] = (1.0, 0.0)
        cb[none, 2] = (0.0, 1.0)
        ok[none, :3] = True

    # Compact to MAX_PTS per slot: order valid-first (stable, so valid
    # candidates keep construction order).
    key = np.where(ok, 0, 1)
    idx = np.argsort(key, axis=1, kind="stable")[:, :MAX_PTS]
    take = np.take_along_axis
    out = np.stack([take(cb[:, :, 0], idx, 1), take(cb[:, :, 1], idx, 1)],
                   axis=2)
    okk = take(ok, idx, 1)
    # Pad invalid tail with the first (always valid) vertex.
    out = np.where(okk[:, :, None], out, out[:, :1, :])
    # Compaction slack (same contract as the device twin): Chebyshev-
    # barycentric distance from any valid candidate to the kept set —
    # covers top_k crowding when > MAX_PTS candidates were valid.
    dch = np.maximum(np.abs(cb[:, :, None, 0] - out[:, None, :, 0]),
                     np.abs(cb[:, :, None, 1] - out[:, None, :, 1]))
    dch = np.where(okk[:, None, :], dch, np.inf)
    dnear = dch.min(axis=2)
    slack = np.where(ok, dnear, 0.0).max(axis=1)
    return (np.ascontiguousarray(out.astype(np.float32)),
            slack.astype(np.float32))


def clip_slots_bary_device(sv0, se1, se2, bmin, bmax,
                           rel_eps: float = 1e-4) -> jnp.ndarray:
    """Device (f32, jit-able) twin of :func:`clip_slots_bary`.

    Same candidate set — (corners-in-box) ∪ (tri-edge × box-face) ∪
    (box-edge × tri-plane) — generated with pure elementwise math over
    all slots at once, then compacted to MAX_PTS per slot with
    ``top_k`` over a validity key. Differences from the host oracle,
    both safe-by-construction:

    - validity epsilons are LOOSER (f32): an extra near-boundary
      candidate only inflates the refit AABB by O(eps·extent), while a
      wrongly-rejected true hull vertex would shrink it — so all
      epsilon error is pushed to the conservative side;
    - exact-duplicate candidates (same quantized bary coords) are
      dropped before compaction so eps-clusters around one hull vertex
      cannot crowd distinct vertices out of the MAX_PTS slots. Kept
      representatives retain full precision; any residual shrink is
      covered by the refit-time padding in :func:`refit_sbvh`.

    Inputs are per-SLOT f32 arrays: triangle corners (v0, e1, e2) and
    the stored clipped slot box (bmin, bmax). Returns f32[S, MAX_PTS, 2].
    """
    s = sv0.shape[0]
    ext = jnp.maximum((bmax - bmin).max(axis=1), 1e-12)     # [S]
    eps = rel_eps * ext
    beps = jnp.float32(1e-4)        # barycentric validity slack

    def world(b1, b2):
        return (sv0 + b1[:, None] * se1 + b2[:, None] * se2)

    def inside_box(p, skip_axis=None):
        ok = jnp.ones((s,), bool)
        for a in range(3):
            if a == skip_axis:
                continue
            ok &= (p[:, a] >= bmin[:, a] - eps) \
                & (p[:, a] <= bmax[:, a] + eps)
        return ok

    zero = jnp.zeros((s,), jnp.float32)
    one = jnp.ones((s,), jnp.float32)
    cand_b1, cand_b2, cand_ok = [], [], []

    # (a) triangle corners inside the box
    for b1, b2 in ((zero, zero), (one, zero), (zero, one)):
        cand_b1.append(b1)
        cand_b2.append(b2)
        cand_ok.append(inside_box(world(b1, b2)))

    # (b) triangle edges x box face planes
    for (pb1, pb2), (qb1, qb2) in ((( zero, zero), (one, zero)),
                                   ((zero, zero), (zero, one)),
                                   ((one, zero), (zero, one))):
        p = world(pb1, pb2)
        q = world(qb1, qb2)
        d = q - p
        for a in range(3):
            for c in (bmin[:, a], bmax[:, a]):
                da = d[:, a]
                safe = jnp.abs(da) > 1e-30
                t = jnp.where(safe,
                              (c - p[:, a]) / jnp.where(safe, da, 1.0),
                              -1.0)
                ok = safe & (t >= -beps) & (t <= 1 + beps)
                t = jnp.clip(t, 0.0, 1.0)
                b1 = pb1 + t * (qb1 - pb1)
                b2 = pb2 + t * (qb2 - pb2)
                ok &= inside_box(world(b1, b2), skip_axis=a)
                cand_b1.append(b1)
                cand_b2.append(b2)
                cand_ok.append(ok)

    # (c) box edges x triangle plane: 2x2 solve for (b1, b2)
    for a in range(3):
        for b in range(a + 1, 3):
            d_axis = 3 - a - b
            for va in (bmin[:, a], bmax[:, a]):
                for vb in (bmin[:, b], bmax[:, b]):
                    m00, m01 = se1[:, a], se2[:, a]
                    m10, m11 = se1[:, b], se2[:, b]
                    det = m00 * m11 - m01 * m10
                    safe = jnp.abs(det) > 1e-30
                    inv = jnp.where(safe, 1.0 / jnp.where(safe, det, 1.0),
                                    0.0)
                    ra = va - sv0[:, a]
                    rb = vb - sv0[:, b]
                    b1 = (m11 * ra - m01 * rb) * inv
                    b2 = (m00 * rb - m10 * ra) * inv
                    ok = safe & (b1 >= -beps) & (b2 >= -beps) \
                        & (b1 + b2 <= 1 + beps)
                    p = world(b1, b2)
                    ok &= (p[:, d_axis] >= bmin[:, d_axis] - eps) \
                        & (p[:, d_axis] <= bmax[:, d_axis] + eps)
                    cand_b1.append(b1)
                    cand_b2.append(b2)
                    cand_ok.append(ok)

    cb1 = jnp.stack(cand_b1, axis=1)          # [S, C]
    cb2 = jnp.stack(cand_b2, axis=1)
    ok = jnp.stack(cand_ok, axis=1)           # [S, C]
    ncand = cb1.shape[1]

    # Degenerate slots: fall back to the full triangle (candidates 0..2
    # ARE the corners by construction).
    none = ~ok.any(axis=1)
    ok = ok | (none[:, None] & (jnp.arange(ncand) < 3))

    # Drop eps-ball duplicates (keep the first of each cluster) so the
    # f32-noise/beps scatter around one hull vertex cannot crowd distinct
    # vertices out of the MAX_PTS slots. A BALL test (not quantized keys)
    # merges every near-duplicate pair regardless of where quantization
    # boundaries fall; tau comfortably exceeds the beps validity scatter.
    ok0 = ok                        # validity before dedup, for the slack
    tau = jnp.float32(2e-4)
    near = (jnp.abs(cb1[:, :, None] - cb1[:, None, :]) <= tau) \
        & (jnp.abs(cb2[:, :, None] - cb2[:, None, :]) <= tau)  # [S, C, C]
    earlier = jnp.tril(jnp.ones((ncand, ncand), bool), k=-1)
    dup = (near & earlier & ok[:, None, :]).any(axis=2)
    ok &= ~dup

    # Compact: top_k over (valid, construction order) — valid-first,
    # stable within validity class.
    score = jnp.where(ok, ncand - jnp.arange(ncand),
                      -jnp.arange(ncand)).astype(jnp.int32)
    _, idx = jax.lax.top_k(score, MAX_PTS)                    # [S, P]
    take = jnp.take_along_axis
    out1 = take(cb1, idx, axis=1)
    out2 = take(cb2, idx, axis=1)
    okk = take(ok, idx, axis=1)
    out1 = jnp.where(okk, out1, out1[:, :1])
    out2 = jnp.where(okk, out2, out2[:, :1])

    # Exact per-slot compaction slack: the largest Chebyshev-barycentric
    # distance from ANY valid candidate (pre-dedup) to the kept vertex
    # set. Covers dedup merges AND top_k crowding; refit_sbvh turns it
    # into a world-space pad of slack * (|e1| + |e2|). Zero when nothing
    # was dropped.
    dch = jnp.maximum(jnp.abs(cb1[:, :, None] - out1[:, None, :]),
                      jnp.abs(cb2[:, :, None] - out2[:, None, :]))
    dch = jnp.where(okk[:, None, :], dch, jnp.inf)            # [S, C, P]
    dnear = dch.min(axis=2)                                   # [S, C]
    slack = jnp.max(jnp.where(ok0, dnear, 0.0), axis=1)       # [S]
    return jnp.stack([out1, out2], axis=2), slack


def slot_boxes_from_nodes(lbvh: LBVH):
    """Per-SLOT stored (clipped) boxes, device-side: the leaf's node box
    repeated over its ``leaf_size`` slots."""
    from .wide import leaf_boxes_from_nodes
    lmin, lmax = leaf_boxes_from_nodes(lbvh)
    k = lbvh.leaf_size
    return (jnp.repeat(lmin, k, axis=0), jnp.repeat(lmax, k, axis=0))


def make_clip_refit(lbvh: LBVH, nw_pad: int,
                    device: bool = True) -> ClipRefitPlan:
    """Per-scene precompute: clip polygons + wide plan.

    ``device=True`` runs the (jitted) f32 polygon extraction on the
    accelerator — milliseconds instead of the ~38 s host-f64 path on
    Sponza-class scenes. The host path remains as the test oracle."""
    import jax
    if device:
        bmin, bmax = slot_boxes_from_nodes(lbvh)
        bary, slack = jax.jit(clip_slots_bary_device)(
            lbvh.tri_v0, lbvh.tri_e1, lbvh.tri_e2, bmin, bmax)
    else:
        bary_np, slack_np = clip_slots_bary(lbvh)
        bary, slack = jnp.asarray(bary_np), jnp.asarray(slack_np)
    plan = jax.jit(make_wide_plan, static_argnames=("nw_pad",))(
        lbvh, nw_pad=nw_pad)
    return ClipRefitPlan(bary=bary, plan=plan, slack=slack)


def refit_sbvh(lbvh: LBVH, bary: jnp.ndarray,
               sv0: jnp.ndarray, se1: jnp.ndarray, se2: jnp.ndarray,
               slack: Optional[jnp.ndarray] = None
               ) -> Tuple[LBVH, Tuple[jnp.ndarray, jnp.ndarray]]:
    """Refit the binary SBVH from deformed SLOT corners (sorted order).

    Returns the refit LBVH plus the clipped leaf boxes (for the wide
    assembly). ``sv0/se1/se2``: f32[S, 3] — the deformed triangle data in
    leaf-slot order (apply elementwise deforms directly to these; no
    vertex gathers needed). ``slack``: optional f32[S] compaction radius
    from the precompute (ClipRefitPlan.slack)."""
    b1 = bary[:, :, 0]                                    # [S, P]
    b2 = bary[:, :, 1]
    p = (sv0[:, None, :] + b1[:, :, None] * se1[:, None, :]
         + b2[:, :, None] * se2[:, None, :])              # [S, P, 3]
    smin = p.min(axis=1)
    smax = p.max(axis=1)
    # Conservative pad: absorbs f32 rounding in the polygon eval (1e-4 of
    # the slot extent — invisible to traversal cost) plus, when the
    # precompute dropped candidate vertices (dedup merge / top_k
    # crowding), their exact barycentric slack scaled by the DEFORMED
    # edge lengths: |Δp| <= |Δb1|·|e1| + |Δb2|·|e2| <= slack·(|e1|+|e2|).
    pad = 1e-4 * (smax - smin).max(axis=1, keepdims=True)
    if slack is not None:
        edge = (jnp.linalg.norm(se1, axis=-1)
                + jnp.linalg.norm(se2, axis=-1))          # [S]
        pad = pad + (slack * edge)[:, None]
    smin = smin - pad
    smax = smax + pad
    k = lbvh.leaf_size
    nl = lbvh.num_leaves
    lmin = smin.reshape(nl, k, 3).min(axis=1)
    lmax = smax.reshape(nl, k, 3).max(axis=1)
    nodes_box, root_min, root_max = _assemble_node_boxes(
        lmin, lmax, lbvh.nodes_child, lbvh.nodes_first, lbvh.nodes_last)
    out = dataclasses.replace(
        lbvh, nodes_box=nodes_box, tri_v0=sv0, tri_e1=se1, tri_e2=se2,
        root_min=root_min, root_max=root_max)
    return out, (lmin, lmax)


def refit_sbvh_wide(plan: ClipRefitPlan, lbvh: LBVH,
                    sv0: jnp.ndarray, se1: jnp.ndarray, se2: jnp.ndarray,
                    vertices: Optional[jnp.ndarray] = None
                    ) -> Tuple[WideBVH, LBVH]:
    """One fused per-frame program: deformed slot corners -> refit binary
    boxes -> wide rows via the static collapse plan. Pass ``vertices``
    instead of corners to use the gather path (sv0/se1/se2 ignored)."""
    if vertices is not None:
        tri = lbvh.tri_sorted
        v0 = vertices[tri[:, 0]]
        sv0, se1, se2 = v0, vertices[tri[:, 1]] - v0, \
            vertices[tri[:, 2]] - v0
    refit, leaf_boxes = refit_sbvh(lbvh, plan.bary, sv0, se1, se2,
                                   slack=plan.slack)
    wide = widen_from_plan(plan.plan, refit, leaf_boxes=leaf_boxes)
    return wide, refit
