"""Binary LBVH -> 8-wide BVH collapse (on-device, vectorized).

Why: a traversal loop is a serial dependency chain (pop -> load -> test ->
push), so per-node latency is ~fixed; an 8-wide tree does the same cull
work in ~1/7th the iterations. This is the standard wide-BVH transform (cf.
CWBVH-style collapses) re-done as pure XLA:

- Every binary internal node's *frontier* — its descendants cut at 3 levels
  or at leaves — is computed for ALL nodes at once by two unrolled masked
  expansions (no recursion).
- The wide-root set (nodes whose frontiers tile the tree: root, then the
  internal refs in any wide root's frontier) is found by a fixed number of
  scatter-OR sweeps (depth/3 <= 21 for our <= 62-deep Karras trees).
- Compaction to dense wide ids uses jnp.nonzero with a static size, so the
  only host sync is reading the wide-node count once per (re)build; refits
  keep the topology and never need it.

Child boxes come from the binary nodes' stored child boxes (internal refs)
or leaf boxes (leaf refs); empty slots get inverted boxes that can never be
hit. Cited against the reference's flat binary BVHNode array
(Source/BVHBuilder.cpp [RECALL]) — same role, widened.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from .lbvh import LBVH

EMPTY = jnp.iinfo(jnp.int32).min
WIDE_FACTOR = 8


@dataclasses.dataclass
class WideBVH:
    """8-wide BVH in row layout (read by the CUDA kernel and the XLA walk).

    nodes  : f32[Nw, 128] — child c occupies floats [16c, 16c+16):
             [bmin.xyz, bmax.xyz, ref, 0...]; ref is a float-encoded exact
             int (>= 0: wide node id, < 0: leaf as -(leaf_id+1)); empty
             slots have inverted boxes (+BIG/-BIG) and ref -1.
    tris   : f32[L, 128] — one leaf per row: triangle j at floats
             [9j, 9j+9) = (v0, e1, e2); leaf_size <= 14.
    tri_id : i32[Tpad] sorted position -> original triangle id.
    root_min/max : f32[3]
    num_wide : static int (actual wide nodes; rows beyond are padding)
    leaf_size : static int
    stack_depth : static int, the per-ray stack both walks allocate — one
             of STACK_SIZES, sized from the tree by ``size_stack``
    """

    nodes: Any
    tris: Any
    tri_id: Any
    root_min: Any
    root_max: Any
    num_wide: int
    leaf_size: int
    stack_depth: int = 64


jax.tree_util.register_pytree_node(
    WideBVH,
    lambda b: ((b.nodes, b.tris, b.tri_id, b.root_min, b.root_max),
               (b.num_wide, b.leaf_size, b.stack_depth)),
    lambda aux, c: WideBVH(*c, num_wide=aux[0], leaf_size=aux[1],
                           stack_depth=aux[2]),
)

# Per-ray stack capacities the walks are built for (the CUDA kernel has one
# instantiation per size). A walk pops one entry and pushes at most 8, so
# along a path through D wide levels at most 7 entries per level wait on
# the stack: 7 * D + 1 entries always suffice.
STACK_SIZES = (64, 128, 256)


def stack_size_for(levels: int) -> int:
    """Smallest of STACK_SIZES that holds any walk of a tree with
    ``levels`` wide levels; ValueError when none does."""
    need = 7 * levels + 1
    for size in STACK_SIZES:
        if need <= size:
            return size
    raise ValueError(f"the 8-wide tree has {levels} levels: its walks need "
                     f"a {need}-entry stack, more than the largest "
                     f"supported ({STACK_SIZES[-1]})")


@jax.jit
def wide_levels_device(nodes: jnp.ndarray) -> jnp.ndarray:
    """i32[] number of wide levels (root = level 1) of the tree in the
    f32[Nw, 128] node rows: parent pointers from the child refs, then
    pointer doubling. Rows no node refers to (padding) count as level 0.
    The root (row 0) is nobody's child, so a ref of 0 is never an edge."""
    nw = nodes.shape[0]
    ref = nodes.reshape(nw, WIDE_FACTOR, 16)[:, :, 6].astype(jnp.int32)
    inner = ref > 0
    own = jnp.repeat(jnp.arange(nw, dtype=jnp.int32), WIDE_FACTOR)
    parent = jnp.full((nw,), -1, jnp.int32).at[
        jnp.where(inner, ref, nw).reshape(-1)].max(own, mode="drop")
    idx = jnp.arange(nw, dtype=jnp.int32)
    # (edges to the root so far, jump target); root and padding point at
    # themselves with no edge.
    depth = (parent >= 0).astype(jnp.int32)
    jump = jnp.where(parent >= 0, parent, idx)
    for _ in range(max(nw, 1).bit_length()):
        depth = depth + depth[jump]
        jump = jump[jump]
    reached = (idx == 0) | (parent >= 0)
    return jnp.max(jnp.where(reached, depth + 1, 0))


def size_stack(wide: WideBVH) -> WideBVH:
    """The accel with its walks' stack sized from its own depth (one host
    sync). ValueError if the tree is too deep for every supported size."""
    levels = int(wide_levels_device(wide.nodes))
    return dataclasses.replace(wide, stack_depth=stack_size_for(levels))


def _expand(child, refs):
    """One masked expansion level: internal refs -> their two children;
    leaves/EMPTY pass through as (ref, EMPTY)."""
    ni = child.shape[0]
    is_int = refs >= 0
    safe = jnp.clip(refs, 0, ni - 1)
    left = jnp.where(is_int, child[safe, 0], refs)
    right = jnp.where(is_int, child[safe, 1], EMPTY)
    return left, right


def frontiers(child: jnp.ndarray) -> jnp.ndarray:
    """i32[Ni, 8]: each internal node's 3-level frontier (refs: internal
    ids >= 0, leaves < 0 as -(leaf+1), EMPTY sentinel).

    Each expansion level is ONE batched gather over all current slots."""
    ni = child.shape[0]
    refs = child                                        # [Ni, 2]
    for _ in range(2):                                  # levels 2 and 3
        is_int = refs >= 0
        safe = jnp.clip(refs, 0, ni - 1)
        kids = child[safe]                              # [Ni, k, 2]
        left = jnp.where(is_int, kids[..., 0], refs)
        right = jnp.where(is_int, kids[..., 1], EMPTY)
        refs = jnp.stack([left, right], axis=-1).reshape(ni, -1)
    return refs                                         # [Ni, 8]


def node_depths(child: jnp.ndarray) -> jnp.ndarray:
    """i32[Ni] depth of every internal node (root = 0), via parent pointers
    + pointer doubling: O(log depth) gathers instead of per-level scatters.
    One scatter (both child sides at once) + one packed [depth, jump]
    gather per doubling step."""
    ni = child.shape[0]
    ref = child.reshape(-1)                             # [2*Ni] row-major
    is_int = ref >= 0
    tgt = jnp.where(is_int, ref, 0)
    own = jnp.repeat(jnp.arange(ni, dtype=jnp.int32), 2)
    parent = jnp.zeros((ni,), jnp.int32).at[tgt].max(
        jnp.where(is_int, own, 0))
    # parent[0] = 0 (root is its own parent) -- max over scatter keeps 0
    # correct because no node claims the root as a child.
    depth = jnp.where(jnp.arange(ni) == 0, 0, 1).astype(jnp.int32)
    state = jnp.stack([depth, parent], axis=1)          # [Ni, 2]
    for _ in range(7):  # 2^7 = 128 > max Karras depth (~62)
        hop = state[state[:, 1]]
        state = jnp.stack([state[:, 0] + hop[:, 0], hop[:, 1]], axis=1)
    return state[:, 0]


def wide_roots(child: jnp.ndarray, front: jnp.ndarray = None,
               sweeps: int = 0) -> jnp.ndarray:
    """bool[Ni]: nodes that become wide-BVH nodes.

    Internal refs occur in frontiers at EXACTLY 3 levels below their wide
    root (the cut depth is fixed; only leaves appear early), so the
    reachable wide-root set is precisely the nodes at depth % 3 == 0."""
    return node_depths(child) % 3 == 0


def frontiers_adaptive(child: jnp.ndarray) -> jnp.ndarray:
    """BFS-greedy frontiers: expand the SHALLOWEST internal slot while the
    row has < 8 slots. Compared to the fixed depth-3 cut this fills wide
    nodes to 8 children whenever the subtree allows (fixed-depth leaves many
    half-empty nodes -> ~2.5x more traversal pops). Internal refs still end
    at depth >= 3 (shallow internals are always expanded first), so the
    reachability propagation below needs <= ceil(62/3)+1 sweeps."""
    ni = child.shape[0]
    big_depth = jnp.int32(127)
    slots = jnp.full((ni, WIDE_FACTOR), EMPTY, jnp.int32)
    depth = jnp.full((ni, WIDE_FACTOR), big_depth, jnp.int32)
    slots = slots.at[:, 0].set(child[:, 0]).at[:, 1].set(child[:, 1])
    depth = depth.at[:, 0].set(1).at[:, 1].set(1)
    count = jnp.full((ni,), 2, jnp.int32)
    lanes = jnp.arange(WIDE_FACTOR)[None, :]

    for _ in range(WIDE_FACTOR - 2):
        is_int = slots >= 0
        key = jnp.where(is_int, depth, big_depth)
        pick = jnp.argmin(key, axis=1)                      # shallowest int
        can = (count < WIDE_FACTOR) & jnp.take_along_axis(
            is_int, pick[:, None], axis=1)[:, 0]
        ref = jnp.take_along_axis(slots, pick[:, None], axis=1)[:, 0]
        refc = jnp.clip(ref, 0, ni - 1)
        d_new = jnp.take_along_axis(depth, pick[:, None], axis=1)[:, 0] + 1
        # replace picked slot with left child, append right child
        at_pick = lanes == pick[:, None]
        at_end = lanes == count[:, None]
        slots = jnp.where(at_pick & can[:, None], child[refc, 0][:, None],
                          slots)
        slots = jnp.where(at_end & can[:, None], child[refc, 1][:, None],
                          slots)
        depth = jnp.where((at_pick | at_end) & can[:, None],
                          d_new[:, None], depth)
        count = count + can.astype(jnp.int32)
    return slots


def frontiers_area(child: jnp.ndarray, nodes_box: jnp.ndarray
                   ) -> jnp.ndarray:
    """SAH-greedy frontiers: expand the LARGEST-AREA internal slot while
    the row has < 8 slots (the classic wide-BVH collapse heuristic: big
    boxes are the likeliest to be hit, so splitting them buys the most
    culling per slot)."""
    ni = child.shape[0]
    # Own box of internal node i = union of its stored child boxes.
    own_min = jnp.minimum(nodes_box[:, 0:3], nodes_box[:, 6:9])
    own_max = jnp.maximum(nodes_box[:, 3:6], nodes_box[:, 9:12])
    ext = jnp.maximum(own_max - own_min, 0.0)
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0])

    slots = jnp.full((ni, WIDE_FACTOR), EMPTY, jnp.int32)
    slots = slots.at[:, 0].set(child[:, 0]).at[:, 1].set(child[:, 1])
    count = jnp.full((ni,), 2, jnp.int32)
    lanes = jnp.arange(WIDE_FACTOR)[None, :]

    for _ in range(WIDE_FACTOR - 2):
        is_int = slots >= 0
        key = jnp.where(is_int, area[jnp.clip(slots, 0, ni - 1)], -1.0)
        pick = jnp.argmax(key, axis=1)                    # largest area
        can = (count < WIDE_FACTOR) & (jnp.take_along_axis(
            key, pick[:, None], axis=1)[:, 0] >= 0.0)
        ref = jnp.take_along_axis(slots, pick[:, None], axis=1)[:, 0]
        refc = jnp.clip(ref, 0, ni - 1)
        at_pick = lanes == pick[:, None]
        at_end = lanes == count[:, None]
        slots = jnp.where(at_pick & can[:, None], child[refc, 0][:, None],
                          slots)
        slots = jnp.where(at_end & can[:, None], child[refc, 1][:, None],
                          slots)
        count = count + can.astype(jnp.int32)
    return slots


def wide_roots_reachable(child: jnp.ndarray, front: jnp.ndarray,
                         sweeps: int = 24) -> jnp.ndarray:
    """General reachability for adaptive frontiers: root is wide; every
    internal ref inside a wide node's frontier is wide."""
    ni = child.shape[0]
    wide = jnp.zeros((ni,), jnp.int32).at[0].set(1)
    for _ in range(sweeps):
        new = jnp.zeros((ni,), jnp.int32)
        for s in range(WIDE_FACTOR):
            ref = front[:, s]
            is_int = ref >= 0
            tgt = jnp.where(is_int, ref, 0)
            new = new.at[tgt].max(wide * is_int.astype(jnp.int32))
        wide = jnp.maximum(wide, new)
    return wide > 0


# Collapse frontier strategy:
#   "fixed" — depth-3 cut (cheapest count program; the per-frame rebuild
#             hot path, app._rebuild_fused, always takes it)
#   "bfs"   — expand shallowest internal first until 8 slots
#   "area"  — expand largest-area internal first (SAH-greedy collapse)
# Area/bfs need the general reachability propagation; area chains can be
# as long as the binary depth, hence the large sweep count (one-time per
# scene on the static path; refits reuse the plan). "area" fills wide
# nodes by the classic SAH-greedy rule and is the static default.
FRONTIER_MODE = "area"


def _front_and_mask(child, nodes_box=None, mode=None):
    mode = mode or FRONTIER_MODE
    if mode == "area" and nodes_box is None:
        # Deferred-box builds (build_lbvh(boxes="defer")) carry no node
        # boxes to rank by area; the fixed cut is the only well-defined
        # frontier there. Count and widen both resolve through here, so
        # the pair stays consistent for any given bvh.
        mode = "fixed"
    if mode == "area":
        front = frontiers_area(child, nodes_box)
        return front, wide_roots_reachable(child, front, sweeps=64)
    if mode == "bfs":
        front = frontiers_adaptive(child)
        return front, wide_roots_reachable(child, front)
    front = frontiers(child)
    return front, wide_roots(child, front)


@partial(jax.jit, static_argnames=("mode",))
def _wide_count_fn(child, nodes_box, mode=None):
    _, mask = _front_and_mask(child, nodes_box, mode=mode)
    return jnp.sum(mask)


def count_wide(bvh: LBVH, mode: str = None) -> int:
    """Host-sync: number of wide nodes (for choosing the padded size).
    Jitted: the scatter sweeps would otherwise run as hundreds of eager
    dispatches. ``mode`` must match the frontier mode the subsequent widen
    uses."""
    return int(_wide_count_fn(bvh.nodes_child, bvh.nodes_box,
                              mode=mode or FRONTIER_MODE))


def wide_count_device(bvh: LBVH, mode: str = None) -> jnp.ndarray:
    """Jittable wide-node count as a DEVICE scalar — lets a fused
    rebuild+collapse program expose the count for opportunistic overflow
    checking without a per-frame host sync (XLA CSE merges this with the
    mask computed inside widen_lbvh in the same program)."""
    _, mask = _front_and_mask(bvh.nodes_child, bvh.nodes_box, mode=mode)
    return jnp.sum(mask)


def _leaf_boxes_from_tris(bvh: LBVH):
    if bvh.leaf_block is not None:
        # Sub-leaf clustered build (lbvh.LBVH docstring): per-tree-leaf
        # boxes are materialized by the build (one side of the block's
        # best internal cut) — deriving them from the triangle blocks
        # would lose exactly the tightness the clustering buys.
        return bvh.leaf_min, bvh.leaf_max
    v0, e1, e2 = bvh.tri_v0, bvh.tri_e1, bvh.tri_e2
    v1 = v0 + e1
    v2 = v0 + e2
    tmin = jnp.minimum(jnp.minimum(v0, v1), v2)
    tmax = jnp.maximum(jnp.maximum(v0, v1), v2)
    n_leaves = bvh.num_leaves
    k = bvh.leaf_size
    return (tmin.reshape(n_leaves, k, 3).min(axis=1),
            tmax.reshape(n_leaves, k, 3).max(axis=1))


def leaf_boxes_from_nodes(bvh: LBVH):
    """Per-leaf boxes scattered out of the stored per-child node boxes.

    Every leaf is the child of exactly one internal node, whose row in
    ``nodes_box`` stores that leaf's box as built. For Karras/object-SAH
    trees this equals the full-triangle leaf box; for SBVH topologies it
    is the CLIPPED box (the union of the leaf's spatially-split reference
    boxes), which is strictly tighter than the full-triangle union —
    using it for the wide tree's leaf slots preserves the native
    builder's spatial-split quality at the leaf level."""
    assert bvh.leaf_block is None, \
        "clustered trees carry explicit leaf boxes (leaf_min/leaf_max)"
    child = bvh.nodes_child
    nl = bvh.num_leaves
    lmin = jnp.full((nl, 3), 3.4e38, jnp.float32)
    lmax = jnp.full((nl, 3), -3.4e38, jnp.float32)
    for lo in (0, 6):                       # [lmin lmax rmin rmax] rows
        ref = child[:, 0 if lo == 0 else 1]
        is_leaf = ref < 0
        tgt = jnp.where(is_leaf, -ref - 1, 0)
        bmin = bvh.nodes_box[:, lo:lo + 3]
        bmax = bvh.nodes_box[:, lo + 3:lo + 6]
        lmin = lmin.at[tgt].min(jnp.where(is_leaf[:, None], bmin, 3.4e38))
        lmax = lmax.at[tgt].max(jnp.where(is_leaf[:, None], bmax, -3.4e38))
    return lmin, lmax


def _assemble_wide_nodes(refs, nodes_box, leaf_min, leaf_max,
                         ids=None, wref=None, leaf_block=None):
    """ONE-gather assembly of the f32[Nw, 128] wide node rows.

    refs: i32[Nw, 8] frontier refs (binary ids >= 0, leaves < 0 as
    -(leaf+1), EMPTY sentinel — pad rows must already be EMPTY).
    A combined candidate table [Ni + Nl + 1, 6|7] holds every possible
    child record (internal: union of stored child boxes; leaf: leaf box;
    last row: inverted/unhittable), so the whole assembly is one row
    gather instead of an 8-children x 4-gathers loop. When ``ids`` (dense
    wide ids per binary node) is given the row ref rides the table as a 7th
    channel; otherwise ``wref`` f32[Nw, 8] supplies pre-remapped refs.
    """
    ni = nodes_box.shape[0]
    nl = leaf_min.shape[0]
    nw = refs.shape[0]
    int_min = jnp.minimum(nodes_box[:, 0:3], nodes_box[:, 6:9])
    int_max = jnp.maximum(nodes_box[:, 3:6], nodes_box[:, 9:12])
    cols = [
        jnp.concatenate([jnp.concatenate([int_min, int_max], axis=1),
                         jnp.concatenate([leaf_min, leaf_max], axis=1),
                         jnp.concatenate(
                             [jnp.full((1, 3), 3.4e38, jnp.float32),
                              jnp.full((1, 3), -3.4e38, jnp.float32)],
                             axis=1)]),
    ]
    if ids is not None:
        # Kernel ref channel: internal -> dense wide id; leaf l -> -(l+1);
        # EMPTY -> -1 (leaf 0 with an inverted box: unhittable, acyclic).
        # Sub-leaf clustered trees (leaf_block given): the KERNEL ref is
        # the triangle-BLOCK id, while the row/box stays the tree-leaf's.
        lref = (jnp.arange(nl, dtype=jnp.float32) if leaf_block is None
                else leaf_block.astype(jnp.float32))
        kref = jnp.concatenate(
            [ids.astype(jnp.float32), -(lref + 1.0),
             jnp.full((1,), -1.0, jnp.float32)])
        cols.append(kref[:, None])
    table = jnp.concatenate(cols, axis=1) if len(cols) > 1 else cols[0]
    row = jnp.where(refs >= 0, refs,
                    jnp.where(refs == EMPTY, ni + nl, ni + (-refs - 1)))
    rec = table[row.reshape(-1)]                       # [Nw*8, 6|7]
    if ids is None:
        rec = jnp.concatenate([rec, wref.reshape(-1, 1)], axis=1)
    rec = jnp.concatenate(
        [rec, jnp.zeros((nw * 8, 16 - rec.shape[1]), jnp.float32)], axis=1)
    return rec.reshape(nw, 128)


def _assemble_wide_nodes_deferred(refs, src, ids, bvh, leaf_min, leaf_max,
                                  leaf_block=None):
    """One-gather assembly WITHOUT materialized binary node boxes (the
    build_lbvh(boxes="defer") fused-rebuild path): the traversal only ever
    reads WIDE nodes' boxes, and every wide node's box is a range query
    over its leaf span, answered straight from the RMQ sparse table. The
    candidate table is [Nw + Nl + 1, 6] indexed by DENSE wide id."""
    from .lbvh import range_boxes
    ni = bvh.nodes_child.shape[0]
    nl = leaf_min.shape[0]
    nw = refs.shape[0]
    fl = jnp.stack([bvh.nodes_first, bvh.nodes_last], axis=1)[src]
    wmin, wmax = range_boxes(leaf_min, leaf_max, fl[:, 0], fl[:, 1])
    table = jnp.concatenate([
        jnp.concatenate([wmin, wmax], axis=1),             # dense wide ids
        jnp.concatenate([leaf_min, leaf_max], axis=1),
        jnp.concatenate([jnp.full((1, 3), 3.4e38, jnp.float32),
                         jnp.full((1, 3), -3.4e38, jnp.float32)], axis=1),
    ])
    dense = ids[jnp.clip(refs, 0, ni - 1)]                 # [Nw, 8]
    row = jnp.where(refs >= 0, dense,
                    jnp.where(refs == EMPTY, nw + nl, nw + (-refs - 1)))
    rec = table[row.reshape(-1)]                           # [Nw*8, 6]
    lref = refs if leaf_block is None else \
        -(leaf_block[jnp.clip(-refs - 1, 0, nl - 1)] + 1)  # block row ref
    kref = jnp.where(refs >= 0, dense.astype(jnp.float32),
                     jnp.where(refs == EMPTY, -1.0,
                               lref.astype(jnp.float32)))
    rec = jnp.concatenate([rec, kref.reshape(-1, 1),
                           jnp.zeros((nw * 8, 9), jnp.float32)], axis=1)
    return rec.reshape(nw, 128)


def make_wide_plan(bvh: LBVH, nw_pad: int, mode: str = None):
    """Topology-only collapse plan: per wide node, the 8 frontier refs (as
    binary/leaf ids, EMPTY-padded) plus their pre-remapped row refs.
    Refits reuse the plan and only re-gather boxes (widen_from_plan)."""
    assert bvh.leaf_block is None, \
        "sub-leaf clustered trees are rebuild-mode only (no refit plans)"
    child = bvh.nodes_child
    ni = child.shape[0]
    front, wide = _front_and_mask(child, bvh.nodes_box, mode=mode)
    ids = jnp.cumsum(wide.astype(jnp.int32)) - 1
    src = jnp.nonzero(wide, size=nw_pad, fill_value=ni - 1)[0]
    rows_front = front[src]
    is_pad = jnp.arange(nw_pad) >= jnp.sum(wide)
    refs = jnp.where(is_pad[:, None], EMPTY, rows_front)        # [Nw, 8]
    wref = jnp.where(refs >= 0, ids[jnp.clip(refs, 0, ni - 1)],
                     jnp.where(refs == EMPTY, -1, refs))
    return refs, wref.astype(jnp.float32)


def widen_from_plan(plan, bvh: LBVH, leaf_boxes=None) -> WideBVH:
    """Assemble the 8-wide node rows from a plan + (possibly refit) LBVH
    boxes. This is the per-frame path for animated meshes: no reachability,
    no count host-sync — just box gathers. ``leaf_boxes`` overrides the
    full-triangle leaf boxes (e.g. clipped boxes on SBVH topologies)."""
    refs, wref = plan
    nw_pad = refs.shape[0]
    leaf_min, leaf_max = leaf_boxes if leaf_boxes is not None \
        else _leaf_boxes_from_tris(bvh)
    nodes = _assemble_wide_nodes(refs, bvh.nodes_box, leaf_min, leaf_max,
                                 wref=wref)

    return WideBVH(nodes=nodes, tris=_leaf_rows(bvh, bvh.num_leaves),
                   tri_id=bvh.tri_id, root_min=bvh.root_min,
                   root_max=bvh.root_max, num_wide=nw_pad,
                   leaf_size=bvh.leaf_size)


def _leaf_rows(bvh: LBVH, rows: int):
    """f32[rows, 128] leaf rows: triangle j of a leaf at floats [9j, 9j+9)
    = (v0, e1, e2). A leaf must fit one row: leaf_size <= 14."""
    k = bvh.leaf_size
    if k * 9 > 128:
        raise ValueError(f"leaf_size {k} does not fit one 128-float leaf "
                         f"row (max 14)")
    tri9 = jnp.stack([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2], axis=1)
    tri9 = tri9.reshape(rows, k * 9)
    return jnp.pad(tri9, ((0, 0), (0, 128 - k * 9)))


def widen_lbvh(bvh: LBVH, nw_pad: int, from_node_boxes: bool = False,
               mode: str = None) -> WideBVH:
    """Collapse to 8-wide. ``nw_pad`` must be >= count_wide(bvh) (static;
    round up to a bucket to avoid recompiles across frames).
    ``from_node_boxes`` takes the leaf slots' boxes from the stored
    per-child node boxes (leaf_boxes_from_nodes) — strictly tighter on
    SBVH topologies, identical on Karras/object trees. ``mode`` overrides
    the module FRONTIER_MODE (fixed/bfs/area)."""
    child = bvh.nodes_child
    ni = child.shape[0]
    front, wide = _front_and_mask(child, bvh.nodes_box, mode=mode)

    # Dense id for every wide binary node (garbage elsewhere).
    ids = jnp.cumsum(wide.astype(jnp.int32)) - 1
    src = jnp.nonzero(wide, size=nw_pad, fill_value=ni - 1)[0]  # wide -> bin
    rows_front = front[src]                                     # [Nw, 8]
    is_pad = jnp.arange(nw_pad) >= jnp.sum(wide)

    # One-gather assembly over a combined candidate table. Internal refs
    # remap to dense wide ids via the table's row-ref channel; EMPTY
    # slots get leaf ref -1 (leaf 0): their inverted box never hits for
    # finite slab products, and if +/-BIG overflows to inf (axis-parallel
    # rays) the worst case is a harmless exact leaf test — an internal
    # ref here (e.g. 0 = root) would create a traversal CYCLE.
    refs = jnp.where(is_pad[:, None], EMPTY, rows_front)
    if bvh.nodes_box is None:                 # build_lbvh(boxes="defer")
        assert not from_node_boxes, \
            "deferred-box builds have no stored node boxes"
        leaf_min, leaf_max = _leaf_boxes_from_tris(bvh)
        nodes = _assemble_wide_nodes_deferred(refs, src, ids, bvh,
                                              leaf_min, leaf_max,
                                              leaf_block=bvh.leaf_block)
    else:
        leaf_min, leaf_max = leaf_boxes_from_nodes(bvh) if from_node_boxes \
            else _leaf_boxes_from_tris(bvh)
        nodes = _assemble_wide_nodes(refs, bvh.nodes_box, leaf_min, leaf_max,
                                     ids=ids, leaf_block=bvh.leaf_block)

    # Leaf/tri rows: one row per triangle BLOCK (equal to num_leaves except
    # on sub-leaf clustered trees).
    tris = _leaf_rows(bvh, bvh.num_blocks)

    return WideBVH(nodes=nodes, tris=tris, tri_id=bvh.tri_id,
                   root_min=bvh.root_min, root_max=bvh.root_max,
                   num_wide=nw_pad, leaf_size=bvh.leaf_size)


def order_children_for_point(wide: WideBVH, point) -> WideBVH:
    """Per-frame near-first child ordering for a shared ray ORIGIN (primary
    rays: the camera). Children are permuted inside each 128-float row so
    the nearest child comes last in slot order (the walks break ties in
    entry distance by slot). Any child permutation is correct; ordering
    only changes efficiency. Costs one small gather per frame.
    """
    rows = wide.nodes.reshape(-1, WIDE_FACTOR, 16)
    center = (rows[:, :, 0:3] + rows[:, :, 3:6]) * 0.5
    d = center - jnp.asarray(point, jnp.float32)
    key = jnp.sum(d * d, axis=-1)
    return _apply_child_order(wide, rows, key)


def order_children_by_area(wide: WideBVH) -> WideBVH:
    """Static (per-scene) child ordering for ANY-HIT queries: pop the
    largest-surface-area child first. Occlusion probability scales with
    box area, so testing big children first lets shadow rays resolve
    (and early-exit) sooner; for lit rays the order is neutral. Unlike the
    per-frame point/direction orderings this is camera/light independent —
    apply once at accel build."""
    rows = wide.nodes.reshape(-1, WIDE_FACTOR, 16)
    ext = jnp.maximum(rows[:, :, 3:6] - rows[:, :, 0:3], 0.0)
    area = (ext[:, :, 0] * ext[:, :, 1] + ext[:, :, 1] * ext[:, :, 2]
            + ext[:, :, 2] * ext[:, :, 0])
    # Smallest key pops first (see _apply_child_order): key = -area.
    return _apply_child_order(wide, rows, -area)


def order_children_for_direction(wide: WideBVH, direction) -> WideBVH:
    """Near-first ordering for a shared ray DIRECTION (directional-light
    shadow rays): sort by box-center projection along the direction, so
    likely occluders are tested first and any-hit rays exit sooner."""
    rows = wide.nodes.reshape(-1, WIDE_FACTOR, 16)
    center = (rows[:, :, 0:3] + rows[:, :, 3:6]) * 0.5
    key = jnp.einsum("nwc,c->nw", center,
                     jnp.asarray(direction, jnp.float32))
    return _apply_child_order(wide, rows, key)


def _apply_child_order(wide: WideBVH, rows, key) -> WideBVH:
    # Empty slots (inverted boxes) sort to the front (pushed first, popped
    # last, and their guard kills them anyway).
    empty = rows[:, :, 0] > rows[:, :, 3]
    key = jnp.where(empty, -3.4e38, key)
    # Ascending: farthest real child in slot 0, nearest in slot 7.
    perm = jnp.argsort(-key, axis=1)
    ordered = jnp.take_along_axis(rows, perm[:, :, None], axis=1)
    return dataclasses.replace(wide,
                               nodes=ordered.reshape(wide.nodes.shape))


def round_up_bucket(n: int, bucket: int = 1024) -> int:
    return -(-n // bucket) * bucket


_widen_jit = jax.jit(widen_lbvh,
                     static_argnames=("nw_pad", "from_node_boxes", "mode"))


@partial(jax.jit, static_argnames=("mode",))
def _wide_count_mode_fn(child, nodes_box, mode):
    _, mask = _front_and_mask(child, nodes_box, mode=mode)
    return jnp.sum(mask)


def build_wide(bvh: LBVH, bucket: int = 1024,
               from_node_boxes: bool = False, mode: str = None) -> WideBVH:
    """Convenience: count (host sync) + widen with bucketed padding + size
    the walks' stack from the result's depth (host sync)."""
    nw = int(_wide_count_mode_fn(bvh.nodes_child, bvh.nodes_box,
                                 mode or FRONTIER_MODE))
    return size_stack(_widen_jit(
        bvh, nw_pad=round_up_bucket(max(nw, 1), bucket),
        from_node_boxes=from_node_boxes, mode=mode))
