"""Implicit 8-ary Morton BVH: the fast per-frame rebuild path (config 2/4).

The Karras+collapse rebuild (lbvh.py + wide.py) spends most of its work on
row gathers: the sort-order gather, the RMQ box queries and the frontier
collapse. This module removes every post-sort gather:

- **Co-sorted payload.** ``lax.sort`` carries the 9-float Möller–Trumbore
  payload (v0, e1, e2) and the 3 vertex ids through the key sort as extra
  operands (the payload arrives already sorted, so leaf packing is a
  reshape).
- **Implicit topology.** Leaves are K consecutive sorted triangles; wide
  node w at each level owns children 8w..8w+7 of the level below. No
  Karras search, no collapse: child references are ``arange`` arithmetic,
  entirely static. (This is the classic implicit/complete LBVH layout —
  an index-median tree over the Morton order instead of Karras's
  radix-prefix tree; the static path keeps the native SBVH.)
- **Pairwise-8 box reduction.** Level boxes by ``reshape(-1, 8, 3).min``
  sweeps — log8(n) fused reductions, no RMQ table, no gathers.

The result is the same ``WideBVH`` row layout the traversals consume
(wide.py): a drop-in accel for the CUDA kernel and ``traverse_wide``.

Reference role: replaces the per-frame use of the CPU SAH builder
(Source/BVHBuilder.cpp [RECALL; mount empty]) for animated scenes —
the reference rebuilds on the host and re-uploads; here the whole build
is one fused device program with no host round-trip (SURVEY.md §3.3).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from .morton import morton_of_points
from .wide import WideBVH, stack_size_for

_BIG = jnp.float32(3.4e38)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def level_sizes(n_leaves: int) -> List[int]:
    """Wide-level sizes bottom-up, ending at the single root."""
    sizes = []
    n = n_leaves
    while True:
        n = -(-n // 8)
        sizes.append(n)
        if n == 1:
            break
    return sizes


def num_wide_implicit(n_leaves: int) -> int:
    return sum(level_sizes(n_leaves))


def _pad_level(bmin, bmax, n_pad: int):
    pad = n_pad - bmin.shape[0]
    if pad:
        bmin = jnp.concatenate(
            [bmin, jnp.full((pad, 3), _BIG, jnp.float32)])
        bmax = jnp.concatenate(
            [bmax, jnp.full((pad, 3), -_BIG, jnp.float32)])
    return bmin, bmax


def build_wide_implicit(vertices: jnp.ndarray, indices: jnp.ndarray,
                        leaf_size: int = 14,
                        with_sorted_ids: bool = False
                        ) -> WideBVH | Tuple[WideBVH, jnp.ndarray]:
    """Fused implicit-topology build: Morton co-sort + level reductions.

    jit-able; all shapes depend only on (num_triangles, leaf_size). With
    ``with_sorted_ids`` also returns the sorted vertex-id triples
    (i32[Tpad, 3]) for the gather-based refit path.
    """
    num_tris = int(indices.shape[0])
    k = leaf_size
    tpad = _round_up(max(num_tris, 2 * k), k)
    pad = tpad - num_tris
    idx = jnp.concatenate(
        [indices, jnp.broadcast_to(indices[-1:], (pad, 3))]) \
        if pad else indices
    tri = idx.astype(jnp.int32)

    v0 = vertices[tri[:, 0]]
    v1 = vertices[tri[:, 1]]
    v2 = vertices[tri[:, 2]]
    ids = tri if with_sorted_ids else None
    return _build_from_corners(v0, v1 - v0, v2 - v0, num_tris, k, ids)


def build_wide_implicit_corners(v0: jnp.ndarray, e1: jnp.ndarray,
                                e2: jnp.ndarray, leaf_size: int = 14
                                ) -> WideBVH:
    """Gather-free build from pre-expanded triangle corners.

    ``v0``/``e1``/``e2``: f32[T, 3] Möller–Trumbore triangle data, one row
    per triangle (no index buffer). This is the per-frame rebuild fast
    path for dynamic scenes: an elementwise deform applied directly to
    the corner representation feeds this with zero vertex gathers.
    """
    num_tris = int(v0.shape[0])
    k = leaf_size
    tpad = _round_up(max(num_tris, 2 * k), k)
    pad = tpad - num_tris
    if pad:
        v0 = jnp.concatenate([v0, jnp.broadcast_to(v0[-1:], (pad, 3))])
        e1 = jnp.concatenate([e1, jnp.broadcast_to(e1[-1:], (pad, 3))])
        e2 = jnp.concatenate([e2, jnp.broadcast_to(e2[-1:], (pad, 3))])
    return _build_from_corners(v0, e1, e2, num_tris, k, None)


def expand_corners(vertices: jnp.ndarray, indices: jnp.ndarray):
    """Per-scene hoist for the corners-in build: (v0, e1, e2) f32[T, 3]."""
    tri = indices.astype(jnp.int32)
    v0 = vertices[tri[:, 0]]
    v1 = vertices[tri[:, 1]]
    v2 = vertices[tri[:, 2]]
    return v0, v1 - v0, v2 - v0


def _build_from_corners(v0, e1, e2, num_tris: int, k: int, tri):
    tpad = v0.shape[0]
    p1 = v0 + e1
    p2 = v0 + e2
    tmin = jnp.minimum(jnp.minimum(v0, p1), p2)
    tmax = jnp.maximum(jnp.maximum(v0, p1), p2)
    centroid = (tmin + tmax) * 0.5
    scene_min = tmin.min(axis=0)
    scene_max = tmax.max(axis=0)
    code = morton_of_points(centroid, scene_min, scene_max)

    # One stable key sort carrying ALL downstream data as payload operands:
    # no post-sort gathers anywhere.
    ops = (code, jnp.arange(tpad, dtype=jnp.int32),
           v0[:, 0], v0[:, 1], v0[:, 2],
           e1[:, 0], e1[:, 1], e1[:, 2],
           e2[:, 0], e2[:, 1], e2[:, 2])
    if tri is not None:
        ops = ops + (tri[:, 0], tri[:, 1], tri[:, 2])
    s = jax.lax.sort(ops, num_keys=1)
    order = s[1]
    sv0 = jnp.stack(s[2:5], axis=1)
    se1 = jnp.stack(s[5:8], axis=1)
    se2 = jnp.stack(s[8:11], axis=1)
    tri_id = jnp.minimum(order, num_tris - 1).astype(jnp.int32)

    wide = _assemble_implicit(sv0, se1, se2, tri_id, k,
                              scene_min, scene_max)
    if tri is not None:
        return wide, jnp.stack(s[11:14], axis=1)
    return wide


def refit_wide_implicit(vertices: jnp.ndarray, tri_sorted: jnp.ndarray,
                        tri_id: jnp.ndarray, leaf_size: int) -> WideBVH:
    """Config-4 fast path on the implicit tree: topology and sorted order
    are frozen; re-gather deformed vertices and redo the (cheap) level
    reductions. No sort, no Morton codes."""
    v0 = vertices[tri_sorted[:, 0]]
    v1 = vertices[tri_sorted[:, 1]]
    v2 = vertices[tri_sorted[:, 2]]
    sv0, se1, se2 = v0, v1 - v0, v2 - v0
    tmin = jnp.minimum(jnp.minimum(v0, v1), v2)
    tmax = jnp.maximum(jnp.maximum(v0, v1), v2)
    return _assemble_implicit(sv0, se1, se2, tri_id, leaf_size,
                              tmin.min(axis=0), tmax.max(axis=0))


def refit_wide_implicit_corners(sv0: jnp.ndarray, se1: jnp.ndarray,
                                se2: jnp.ndarray, tri_id: jnp.ndarray,
                                leaf_size: int) -> WideBVH:
    """Gather-free refit: deformed corners already in sorted (slot) order.

    After one ``build_wide_implicit`` the sorted corner arrays can be kept
    as the animation state; an elementwise deform feeds this directly."""
    p1 = sv0 + se1
    p2 = sv0 + se2
    tmin = jnp.minimum(jnp.minimum(sv0, p1), p2)
    tmax = jnp.maximum(jnp.maximum(sv0, p1), p2)
    return _assemble_implicit(sv0, se1, se2, tri_id, leaf_size,
                              tmin.min(axis=0), tmax.max(axis=0))


def _assemble_implicit(sv0, se1, se2, tri_id, k: int,
                       scene_min, scene_max) -> WideBVH:
    tpad = sv0.shape[0]
    n_leaves = tpad // k

    # Leaf boxes from the sorted triangle payload (pure reshape reduce).
    p1 = sv0 + se1
    p2 = sv0 + se2
    tmin = jnp.minimum(jnp.minimum(sv0, p1), p2)
    tmax = jnp.maximum(jnp.maximum(sv0, p1), p2)
    leaf_min = tmin.reshape(n_leaves, k, 3).min(axis=1)
    leaf_max = tmax.reshape(n_leaves, k, 3).max(axis=1)

    sizes = level_sizes(n_leaves)                     # bottom-up
    # Per wide level: children boxes [n, 8, 3] and node boxes [n, 3].
    child_boxes = []
    cur_min, cur_max = leaf_min, leaf_max
    for s in sizes:
        pmin, pmax = _pad_level(cur_min, cur_max, s * 8)
        gmin = pmin.reshape(s, 8, 3)
        gmax = pmax.reshape(s, 8, 3)
        child_boxes.append((gmin, gmax))
        cur_min = gmin.min(axis=1)
        cur_max = gmax.max(axis=1)

    # Top-down node numbering: root level first. offsets[b] = id of the
    # first node of bottom-up level b.
    nw = sum(sizes)
    offsets = []
    acc = nw
    for s in sizes:                                   # bottom-up walk
        acc -= s
        offsets.append(acc)
    # offsets[b] for bottom-up index b: root (last) gets 0.

    rows = []
    n_below_count = [n_leaves] + sizes[:-1]           # children per level
    for b in range(len(sizes) - 1, -1, -1):           # emit top-down
        s = sizes[b]
        gmin, gmax = child_boxes[b]
        c = jnp.arange(s * 8, dtype=jnp.int32).reshape(s, 8)
        in_range = c < n_below_count[b]
        if b == 0:
            ref = jnp.where(in_range, -(c + 1), -1)
        else:
            ref = jnp.where(in_range, offsets[b - 1] + c, -1)
        lane = jnp.concatenate(
            [gmin, gmax, ref.astype(jnp.float32)[:, :, None],
             jnp.zeros((s, 8, 9), jnp.float32)], axis=2)   # [s, 8, 16]
        rows.append(lane.reshape(s, 128))
    nodes = jnp.concatenate(rows, axis=0)
    # Sublane-align the node rows (padding rows are unreachable: traversal
    # only follows refs, and nothing references them).
    nw_pad = _round_up(nw, 8)
    if nw_pad != nw:
        nodes = jnp.pad(nodes, ((0, nw_pad - nw), (0, 0)))

    tri9 = jnp.stack([sv0, se1, se2], axis=1).reshape(n_leaves, k * 9)
    tris = jnp.pad(tri9, ((0, 0), (0, 128 - k * 9)))

    return WideBVH(nodes=nodes, tris=tris, tri_id=tri_id,
                   root_min=scene_min, root_max=scene_max,
                   num_wide=nw, leaf_size=k,
                   stack_depth=stack_size_for(len(sizes)))
