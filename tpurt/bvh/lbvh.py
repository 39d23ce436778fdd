"""On-device LBVH: Morton sort + Karras-2012 topology + RMQ box computation.

This is the on-device replacement for the reference's CPU BVH builder
(Source/BVHBuilder.cpp ``BVHBuilder::build``: recursive SAH/median split +
depth-first flatten with skip links [RECALL; mount empty at survey time]).
Rationale (SURVEY.md §3.3): a recursive CPU build takes seconds for
Sponza-class meshes and would leave the accelerator idle; the LBVH pipeline is
embarrassingly parallel and runs fully inside jit, enabling per-frame rebuilds
(BASELINE config 2) and cheap refits for animation (config 4).

Design notes:

- **Leaves are K consecutive Morton-sorted triangles.** Triangle data is
  gathered once into sorted order, so every leaf is a *contiguous* slice —
  the traversal kernels stream leaf triangles with dense reads instead of
  per-triangle gathers.
- **Topology** is Karras 2012: every internal node found independently by
  binary search over common-prefix lengths. All loops here are fixed-bound
  with masking => one fused XLA program, no host control flow.
- **Node AABBs via range-min/max query (RMQ)** instead of the classic
  bottom-up atomic-flag walk (which XLA has no efficient analogue for):
  internal node *i* covers the contiguous sorted-leaf range [first_i, last_i],
  so its box is a range reduction over leaf boxes. We build an O(n log n)
  sparse table in log2(n) vectorized sweeps and answer every node's box with
  two gathers. The same routine IS the refit fast path (config 4): topology
  fixed, recompute leaf boxes + table + node boxes.
- **Stackless-depth bound**: delta (common-prefix length) strictly increases
  root->leaf and is <= 60 + 32 (code bits + index-tiebreak bits), so
  traversal stacks of 128 entries are provably sufficient.

The flattened node layout stores, per internal node, BOTH children's boxes
(so the traversal tests 2 boxes per fetched row) and child references with
leaves encoded as negative ids — the same role as the reference's
``BVHNode{bboxMin, bboxMax, prim, next}`` but shaped for vector hardware.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from .morton import morton_of_points, morton_of_points_60
from ..types import Mesh


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class LBVH:
    """Flattened LBVH (all arrays device-resident, jit-friendly).

    Ni = n_leaves - 1 internal nodes; leaf ``l`` covers sorted triangles
    [l*leaf_size, (l+1)*leaf_size).

    nodes_box   : f32[Ni, 12] = [Lmin, Lmax, Rmin, Rmax] child boxes
    nodes_child : i32[Ni, 2]  child refs; >= 0 internal index, < 0 leaf
                  encoded as -(leaf_id + 1)
    nodes_first : i32[Ni] first covered sorted-leaf index (refit metadata)
    nodes_last  : i32[Ni] last covered sorted-leaf index (inclusive)
    tri_v0/e1/e2: f32[Tpad, 3] Morton-sorted precomputed triangle data
                  (the Möller–Trumbore layout the reference bakes into
                  leaves [RECALL])
    tri_sorted  : i32[Tpad, 3] vertex indices in sorted order (refit path)
    tri_id      : i32[Tpad] sorted position -> original triangle id
    root_min/max: f32[3] scene bounds
    leaf_size   : static int

    Sub-leaf clustering (build_lbvh(split_blocks=M), config-2 rebuild
    quality). When ``leaf_block`` is not None the TREE's leaves
    are L = num_blocks + M *sub-leaves*: tree-leaf ``l`` has its own
    tight box (``leaf_min/leaf_max[l]`` — one side of the best internal
    Morton-jump cut of its block) but its triangle content is the FULL
    14-triangle block ``leaf_block[l]`` (rows [blk*k, (blk+1)*k)). The
    box gates traversal visits (the quality win: fewer node visits than
    fixed chops); scanning the whole block on a visit costs the same k
    triangle tests either way, so the triangle arrays never need the
    [L*k] re-gather a physical re-layout would cost.

    leaf_block  : i32[L] tree-leaf -> triangle-block id, or None
    leaf_min/max: f32[L, 3] per-tree-leaf boxes, or None (derive from
                  the k-chop triangle blocks)
    """

    nodes_box: Any
    nodes_child: Any
    nodes_first: Any
    nodes_last: Any
    tri_v0: Any
    tri_e1: Any
    tri_e2: Any
    tri_sorted: Any
    tri_id: Any
    root_min: Any
    root_max: Any
    leaf_size: int = 4
    leaf_block: Any = None
    leaf_min: Any = None
    leaf_max: Any = None

    @property
    def num_internal(self) -> int:
        return int(self.nodes_child.shape[0])

    @property
    def num_leaves(self) -> int:
        return self.num_internal + 1

    @property
    def num_sorted_tris(self) -> int:
        return int(self.tri_id.shape[0])

    @property
    def num_blocks(self) -> int:
        """Triangle blocks (= leaves unless sub-leaf clustered)."""
        return self.num_sorted_tris // self.leaf_size


jax.tree_util.register_pytree_node(
    LBVH,
    lambda b: ((b.nodes_box, b.nodes_child, b.nodes_first, b.nodes_last,
                b.tri_v0, b.tri_e1, b.tri_e2, b.tri_sorted, b.tri_id,
                b.root_min, b.root_max, b.leaf_block, b.leaf_min,
                b.leaf_max), (b.leaf_size,)),
    lambda aux, c: LBVH(*c[:11], leaf_size=aux[0], leaf_block=c[11],
                        leaf_min=c[12], leaf_max=c[13]),
)


# ---------------------------------------------------------------------------
# Karras topology
# ---------------------------------------------------------------------------

def _make_delta(codes):
    """delta(i, j): common-prefix length of 60-bit leaf keys (two uint32
    words), index-augmented so all keys are distinct (Karras 2012 §4);
    -1 outside [0, n-1]. Range: [0, 64+32].

    Single-word specialization: when the low word is all zeros (30-bit
    Morton, the default), the lo gather is skipped entirely — half the
    gathers of the Karras searches."""
    hi, lo = codes
    n = hi.shape[0]
    hi = hi.astype(jnp.uint32)
    single = lo is None
    if not single:
        lo = lo.astype(jnp.uint32)

    def delta(i: jnp.ndarray, j: jnp.ndarray) -> jnp.ndarray:
        valid = (j >= 0) & (j <= n - 1)
        jc = jnp.clip(j, 0, n - 1)
        xh = hi[i] ^ hi[jc]
        ii = i.astype(jnp.int32)
        jj = jc.astype(jnp.int32)
        tie = 64 + jax.lax.clz((ii ^ jj).astype(jnp.uint32)).astype(jnp.int32)
        if single:
            d_lo = tie
        else:
            xl = lo[i] ^ lo[jc]
            d_lo = jnp.where(xl == 0, tie,
                             32 + jax.lax.clz(xl).astype(jnp.int32))
        d = jnp.where(xh == 0, d_lo, jax.lax.clz(xh).astype(jnp.int32))
        return jnp.where(valid, d, jnp.int32(-1))

    return delta


def karras_topology(leaf_codes) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Internal-node topology from sorted leaf keys (tuple of hi/lo words).

    Returns (child i32[Ni, 2], first i32[Ni], last i32[Ni]) with leaves
    encoded as -(leaf_id + 1). Fully vectorized: every loop is a
    log2(n)-bounded masked sweep (SURVEY.md §3.3).
    """
    if not isinstance(leaf_codes, tuple):
        leaf_codes = (leaf_codes, None)
    n = int(leaf_codes[0].shape[0])
    assert n >= 2, "need at least two leaves"
    ni = n - 1
    # Sweep counts scale with the actual leaf count: ranges can never exceed
    # n, so log2(n)+1 masked steps suffice (a fixed 31/32 would re-gather the
    # code array ~3x more than needed; the gathers dominate build time).
    log_n = max((n - 1).bit_length(), 1)
    delta = _make_delta(leaf_codes)
    i = jnp.arange(ni, dtype=jnp.int32)

    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    delta_min = delta(i, i - d)

    # Binary search for the exact range length l, directly over the full
    # [0, 2^log_n] span. Sorted keys make delta(i, j) the MIN of adjacent
    # deltas over [i, j), hence monotone non-increasing in |j - i|, so no
    # doubling pre-search for an upper bound is needed (Karras 2012 uses
    # one for memory locality); dropping it halves the search's gather
    # count.
    l = jnp.zeros((ni,), jnp.int32)
    for k in range(log_n, -1, -1):
        t = jnp.int32(1 << k)
        ok = delta(i, i + (l + t) * d) > delta_min
        l = jnp.where(ok, l + t, l)

    j = i + l * d
    delta_node = delta(i, j)

    # Split search (ceil-halving do-while, masked to log2(n)+2 steps).
    s = jnp.zeros((ni,), jnp.int32)
    t = l
    done = l == 0
    for _ in range(log_n + 2):
        t = (t + 1) >> 1
        ok = (~done) & (delta(i, i + (s + t) * d) > delta_node)
        s = jnp.where(ok, s + t, s)
        done = done | (t <= 1)

    gamma = i + s * d + jnp.minimum(d, 0)
    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)
    left_leaf = first == gamma
    right_leaf = last == gamma + 1
    child_l = jnp.where(left_leaf, -(gamma + 1), gamma)
    child_r = jnp.where(right_leaf, -(gamma + 2), gamma + 1)
    child = jnp.stack([child_l, child_r], axis=1).astype(jnp.int32)
    return child, first.astype(jnp.int32), last.astype(jnp.int32)


# ---------------------------------------------------------------------------
# RMQ sparse table over leaf boxes -> node boxes (build AND refit path)
# ---------------------------------------------------------------------------

def _floor_log2(x: jnp.ndarray) -> jnp.ndarray:
    return 31 - jax.lax.clz(x.astype(jnp.uint32)).astype(jnp.int32)


# Sparse-table construction strategy for range_boxes:
#   "gather" — per-level clipped-index gathers (two tables, min and max)
#   "packed" — ONE min-only table over [leaf_min, -leaf_max] built with
#              static shift-slices instead of gathers (fewer, cheaper
#              ops)
RMQ_VARIANT = "packed"


def range_boxes(leaf_min: jnp.ndarray, leaf_max: jnp.ndarray,
                first: jnp.ndarray, last: jnp.ndarray,
                variant: str = None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """AABB over each inclusive leaf range [first, last] via a sparse table.

    leaf_min/max: f32[n, 3]; first/last: i32[Q]. Returns (f32[Q,3], f32[Q,3]).
    Build: log2(n) vectorized sweeps; query: two gathers per range.
    """
    if (variant or RMQ_VARIANT) == "packed":
        return _range_boxes_packed(leaf_min, leaf_max, first, last)
    n = int(leaf_min.shape[0])
    levels = max(1, n.bit_length())  # 2^(levels-1) <= n
    tmins = [leaf_min]
    tmaxs = [leaf_max]
    for k in range(1, levels):
        shift = 1 << (k - 1)
        idx = jnp.minimum(jnp.arange(n) + shift, n - 1)
        tmins.append(jnp.minimum(tmins[-1], tmins[-1][idx]))
        tmaxs.append(jnp.maximum(tmaxs[-1], tmaxs[-1][idx]))
    tmin = jnp.stack(tmins)  # [levels, n, 3]
    tmax = jnp.stack(tmaxs)

    length = last - first + 1
    k = jnp.clip(_floor_log2(length), 0, levels - 1)
    p2 = (jnp.int32(1) << k)
    a = first
    b = jnp.maximum(last - p2 + 1, 0)
    out_min = jnp.minimum(tmin[k, a], tmin[k, b])
    out_max = jnp.maximum(tmax[k, a], tmax[k, b])
    return out_min, out_max


def _range_boxes_packed(leaf_min, leaf_max, first, last):
    """range_boxes via a single min-only table over [leaf_min, -leaf_max]
    (negating max turns both reductions into one jnp.minimum) built with
    static shift-slices: row i of level k is min over rows [i, i+2^k), with
    out-of-range rows clamped to the last row — exactly the clipped-index
    gather the "gather" variant uses, as a slice+concat instead."""
    n = int(leaf_min.shape[0])
    levels = max(1, n.bit_length())
    t = jnp.concatenate([leaf_min, -leaf_max], axis=1)       # [n, 6]
    tabs = [t]
    for k in range(1, levels):
        s = 1 << (k - 1)
        t = tabs[-1]
        shifted = jnp.concatenate(
            [t[s:], jnp.broadcast_to(t[n - 1:n], (s, 6))])
        tabs.append(jnp.minimum(t, shifted))
    tab = jnp.stack(tabs)                                    # [levels, n, 6]

    length = last - first + 1
    k = jnp.clip(_floor_log2(length), 0, levels - 1)
    p2 = (jnp.int32(1) << k)
    a = first
    b = jnp.maximum(last - p2 + 1, 0)
    r = jnp.minimum(tab[k, a], tab[k, b])                    # [Q, 6]
    return r[:, 0:3], -r[:, 3:6]


def _assemble_node_boxes(leaf_min, leaf_max, child, first, last):
    """Per-node [Lmin Lmax Rmin Rmax] rows from leaf boxes + topology."""
    node_min, node_max = range_boxes(leaf_min, leaf_max, first, last)
    ni = child.shape[0]

    def child_box(c):
        is_leaf = c < 0
        leaf_id = jnp.clip(-c - 1, 0, leaf_min.shape[0] - 1)
        node_id = jnp.clip(c, 0, ni - 1)
        bmin = jnp.where(is_leaf[:, None], leaf_min[leaf_id], node_min[node_id])
        bmax = jnp.where(is_leaf[:, None], leaf_max[leaf_id], node_max[node_id])
        return bmin, bmax

    lmin, lmax = child_box(child[:, 0])
    rmin, rmax = child_box(child[:, 1])
    nodes_box = jnp.concatenate([lmin, lmax, rmin, rmax], axis=1)
    return nodes_box, node_min[0], node_max[0]


# ---------------------------------------------------------------------------
# Build + refit
# ---------------------------------------------------------------------------

def _sorted_tri_data(vertices, tri_sorted):
    v0 = vertices[tri_sorted[:, 0]]
    v1 = vertices[tri_sorted[:, 1]]
    v2 = vertices[tri_sorted[:, 2]]
    return v0, v1 - v0, v2 - v0


def _leaf_boxes(v0, e1, e2, leaf_size: int):
    v1 = v0 + e1
    v2 = v0 + e2
    tmin = jnp.minimum(jnp.minimum(v0, v1), v2)
    tmax = jnp.maximum(jnp.maximum(v0, v1), v2)
    n_leaves = v0.shape[0] // leaf_size
    lmin = tmin.reshape(n_leaves, leaf_size, 3).min(axis=1)
    lmax = tmax.reshape(n_leaves, leaf_size, 3).max(axis=1)
    return lmin, lmax, tmin, tmax


def _subleaf_split(chs, tmin_s, tmax_s, k: int, m: int):
    """Sub-leaf clustering pass (config-2 rebuilt-tree quality).

    The fixed k-chop leaves of the Morton order are the rebuilt tree's
    quality ceiling: a chop that straddles a big spatial jump gets a huge
    box and eats traversal visits.
    This pass splits the top-``m`` blocks (ranked by their largest
    internal adjacent-code XOR — the Morton-jump magnitude) at that
    boundary, emitting TWO tree-leaves with tight boxes that both
    reference the same triangle block — so the triangle arrays never
    move (no [L*k] re-gather; see the LBVH docstring).

    chs: u32[Tpad] sorted codes; tmin_s/tmax_s: f32[Tpad, 3] sorted
    per-triangle boxes. Returns (leaf_block i32[L], sub_codes u32[L],
    sub_min f32[L,3], sub_max f32[L,3]) with L = Tpad//k + m exactly.
    """
    tpad = chs.shape[0]
    nb = tpad // k
    assert 0 < m <= nb, (m, nb)
    big = jnp.float32(3.4e38)

    # Boundary scores: XOR of adjacent sorted codes, remapped to a
    # signed view that preserves unsigned order (msb flip).
    x = chs[:-1] ^ chs[1:]
    xi = (x ^ jnp.uint32(0x80000000)).astype(jnp.int32)
    xi = jnp.concatenate(
        [xi, jnp.full((1,), jnp.iinfo(jnp.int32).min, jnp.int32)])
    sc = xi.reshape(nb, k)[:, :k - 1]       # col c-1 scores a cut at c
    best_c = jnp.argmax(sc, axis=1).astype(jnp.int32) + 1
    best_s = jnp.max(sc, axis=1)

    # Exact top-m split set (sort is over nb blocks, not Tpad tris).
    blk = jnp.arange(nb, dtype=jnp.int32)
    _, ordb = jax.lax.sort((-best_s, blk), num_keys=1)
    split = jnp.zeros((nb,), jnp.bool_).at[ordb[:m]].set(True)

    # Side boxes as two masked reduces over packed [tmin, -tmax] (cheaper
    # than prefix/suffix tables + gathers: only the split row's prefix
    # and suffix are ever read).
    t6 = jnp.concatenate([tmin_s, -tmax_s], axis=1).reshape(nb, k, 6)
    end_a = jnp.where(split, best_c, k)     # A covers rows [0, end_a)
    slot = jnp.arange(k, dtype=jnp.int32)[None, :, None]
    box_a = jnp.min(jnp.where(slot < end_a[:, None, None], t6, big), axis=1)
    box_b = jnp.min(jnp.where(slot >= best_c[:, None, None], t6, big),
                    axis=1)

    # Sub-leaf stream u = 2b (A, always) / 2b+1 (B, iff split), compacted
    # to exactly L = nb + m tree-leaves in Morton order.
    ones = jnp.ones((nb,), jnp.bool_)
    emit = jnp.stack([ones, split], axis=1).reshape(-1)
    offs = jnp.stack([jnp.zeros((nb,), jnp.int32), best_c],
                     axis=1).reshape(-1)
    boxes = jnp.stack([box_a, box_b], axis=1).reshape(2 * nb, 6)
    n_leaves = nb + m
    lid = jnp.cumsum(emit.astype(jnp.int32)) - 1
    u = jnp.arange(2 * nb, dtype=jnp.int32)
    compact_src = jnp.zeros((n_leaves,), jnp.int32).at[
        jnp.where(emit, lid, n_leaves)].set(u, mode="drop")
    leaf_block = compact_src >> 1
    sub_codes = chs[leaf_block * k + offs[compact_src]]
    b6 = boxes[compact_src]
    return leaf_block, sub_codes, b6[:, :3], -b6[:, 3:]


def auto_split_blocks(num_tris: int, leaf_size: int) -> int:
    """Default sub-leaf split count M for RenderConfig.rebuild_splits=-1:
    a quarter of the blocks (splitting more blocks lengthens the build
    for little further gain in trace time)."""
    tpad = _round_up(max(int(num_tris), 2 * leaf_size), leaf_size)
    return tpad // leaf_size // 4


def build_lbvh(vertices: jnp.ndarray, indices: jnp.ndarray,
               leaf_size: int = 4, morton_bits: int = 30,
               boxes: str = "full", split_blocks: int = 0) -> LBVH:
    """Full on-device build: sort + topology + boxes. jit-able; all shapes
    depend only on (num_triangles, leaf_size).

    morton_bits: 30 (single-word sort, fastest build, the default) or 60
    (two-word keys; restores spatial ordering where 30-bit codes collide —
    ~68% duplicate codes on Sponza-class density — at a longer sort; the
    safer choice for very dense or thin-feature meshes).

    boxes: "full" materializes the per-node child boxes (``nodes_box``) —
    required for binary traversal, refits, the wide-plan path and the area
    collapse. "defer" leaves ``nodes_box = None``: a fixed-cut 8-wide
    collapse only ever reads the ~Ni/7 wide nodes' boxes, which widen_lbvh
    then queries straight from the RMQ sparse table.

    split_blocks: M > 0 enables sub-leaf clustering (config-2 rebuilt-
    tree quality): the top-M triangle blocks by internal Morton-jump are
    split at their best boundary into two tight-boxed tree-leaves that
    share the block's triangle rows (see _subleaf_split / the LBVH
    docstring). Leaf count becomes Tpad//leaf_size + M. 30-bit codes
    only; incompatible with refit paths."""
    if split_blocks:
        assert morton_bits == 30, "sub-leaf clustering needs 30-bit codes"
    num_tris = int(indices.shape[0])
    tpad = _round_up(max(num_tris, 2 * leaf_size), leaf_size)
    pad = tpad - num_tris
    # Pad by repeating the last triangle: duplicates are harmless for both
    # any-hit and closest-hit queries and keep every box tight.
    idx = jnp.concatenate(
        [indices, jnp.broadcast_to(indices[-1:], (pad, 3))]) if pad else indices

    tri = idx.astype(jnp.int32)
    v = vertices[tri.reshape(-1)].reshape(tpad, 3, 3)
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    tmin = jnp.minimum(jnp.minimum(v0, v1), v2)
    tmax = jnp.maximum(jnp.maximum(v0, v1), v2)
    centroid = (tmin + tmax) * 0.5
    # Packed scene-bounds reduction: one min over [tmin, -tmax].
    pb = jnp.concatenate([tmin, -tmax], axis=1).min(axis=0)
    scene_min, scene_max = pb[:3], -pb[3:]

    # ONE key sort carrying ALL downstream per-triangle data as payload
    # operands: v0/e1/e2 (Möller–Trumbore), the vertex-id triple (refit)
    # and the original index — no post-sort row gathers.
    e1 = v1 - v0
    e2 = v2 - v0
    payload = (jnp.arange(tpad, dtype=jnp.int32),
               v0[:, 0], v0[:, 1], v0[:, 2],
               e1[:, 0], e1[:, 1], e1[:, 2],
               e2[:, 0], e2[:, 1], e2[:, 2],
               tri[:, 0], tri[:, 1], tri[:, 2])
    if morton_bits == 60:
        chi, clo = morton_of_points_60(centroid, scene_min, scene_max)
        s = jax.lax.sort((chi, clo) + payload, num_keys=2)
        chs, cls, s = s[0], s[1], s[2:]
        leaf_codes = (chs[::leaf_size], cls[::leaf_size])
    else:
        chi = morton_of_points(centroid, scene_min, scene_max)
        s = jax.lax.sort((chi,) + payload, num_keys=1)
        chs, s = s[0], s[1:]
        leaf_codes = (chs[::leaf_size], None)
    order = s[0]
    # Padded rows are literal copies of triangle T-1, so clamping their ids
    # keeps shading lookups (albedo/normals by original id) in range while
    # refit gathers identical geometry.
    tri_id = jnp.minimum(order, num_tris - 1).astype(jnp.int32)
    sv0 = jnp.stack(s[1:4], axis=1)
    se1 = jnp.stack(s[4:7], axis=1)
    se2 = jnp.stack(s[7:10], axis=1)
    tri_sorted = jnp.stack(s[10:13], axis=1)
    leaf_block = None
    if split_blocks:
        _, _, tmin_s, tmax_s = _leaf_boxes(sv0, se1, se2, leaf_size)
        leaf_block, sub_codes, lmin, lmax = _subleaf_split(
            chs, tmin_s, tmax_s, leaf_size, int(split_blocks))
        leaf_codes = (sub_codes, None)
    else:
        lmin, lmax, _, _ = _leaf_boxes(sv0, se1, se2, leaf_size)

    child, first, last = karras_topology(leaf_codes)

    if boxes == "defer":
        # Root box = reduction over the LEAF boxes (not the raw scene
        # bounds: leaf boxes use reconstructed corners v0+e1/v0+e2, which
        # round ~1 ulp from the originals — this keeps the deferred path
        # bit-identical to the full path's RMQ root).
        pb2 = jnp.concatenate([lmin, -lmax], axis=1).min(axis=0)
        return LBVH(nodes_box=None, nodes_child=child, nodes_first=first,
                    nodes_last=last, tri_v0=sv0, tri_e1=se1, tri_e2=se2,
                    tri_sorted=tri_sorted, tri_id=tri_id,
                    root_min=pb2[:3], root_max=-pb2[3:],
                    leaf_size=leaf_size, leaf_block=leaf_block,
                    leaf_min=lmin if leaf_block is not None else None,
                    leaf_max=lmax if leaf_block is not None else None)
    nodes_box, root_min, root_max = _assemble_node_boxes(
        lmin, lmax, child, first, last)

    return LBVH(nodes_box=nodes_box, nodes_child=child, nodes_first=first,
                nodes_last=last, tri_v0=sv0, tri_e1=se1, tri_e2=se2,
                tri_sorted=tri_sorted, tri_id=tri_id, root_min=root_min,
                root_max=root_max, leaf_size=leaf_size,
                leaf_block=leaf_block,
                leaf_min=lmin if leaf_block is not None else None,
                leaf_max=lmax if leaf_block is not None else None)


def refit_lbvh(bvh: LBVH, vertices: jnp.ndarray, indices: jnp.ndarray) -> LBVH:
    """Config-4 fast path: same topology + sorted order, new vertex positions.

    Cost: one gather over triangles + log2(n_leaves) reduction sweeps — no
    sort, no topology search. The analogue of the classic bottom-up refit,
    reformulated as RMQ so it is a single fused XLA program.
    """
    del indices  # topology is frozen; sorted vertex ids live in the LBVH
    assert bvh.leaf_block is None, \
        "sub-leaf clustered trees are rebuild-mode only (refit would " \
        "need the stored split offsets; rebuild instead)"
    sv0, se1, se2 = _sorted_tri_data(vertices, bvh.tri_sorted)
    lmin, lmax, _, _ = _leaf_boxes(sv0, se1, se2, bvh.leaf_size)
    nodes_box, root_min, root_max = _assemble_node_boxes(
        lmin, lmax, bvh.nodes_child, bvh.nodes_first, bvh.nodes_last)
    return dataclasses.replace(
        bvh, nodes_box=nodes_box, tri_v0=sv0, tri_e1=se1, tri_e2=se2,
        root_min=root_min, root_max=root_max)


def sah_cost(bvh: LBVH) -> jnp.ndarray:
    """Relative SAH quality metric: sum of child-box surface areas divided by
    root surface area. Drives the rebuild-vs-refit policy (config 4): refits
    inflate boxes over time; rebuild when cost rises past a threshold."""
    def area(bmin, bmax):
        d = jnp.maximum(bmax - bmin, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    box = bvh.nodes_box
    a = area(box[:, 0:3], box[:, 3:6]) + area(box[:, 6:9], box[:, 9:12])
    root = area(bvh.root_min, bvh.root_max)
    return jnp.sum(a) / jnp.maximum(root, 1e-12)
