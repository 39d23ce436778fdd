"""Native SAH build -> LBVH-format conversion (static-scene accel path).

The reference builds its BVH with a recursive CPU SAH split at startup
(Source/BVHBuilder.cpp [RECALL]) and only the traversal runs per frame.
This module gives this pipeline the same option: the C++ binned-SAH
builder (native/tpurt_native.cpp) runs once per scene on the host, and its
DFS + skip-link tree is converted to the exact LBVH array layout the wide
collapse and the traversals consume.

Why: an SAH tree culls better than the on-device Morton/Karras tree, so
every traversal visits fewer nodes. Cost: variable SAH leaf occupancy
repeat-pads the triangle arrays (~1.46x on Sponza-class scenes at leaf
14), and the build is a host-side scene-load step — so this is the
STATIC-scene path; per-frame rebuilds (config 2) keep the on-device LBVH
and refits (config 4) the clip-geometry refit of this tree.

The conversion also derives contiguous per-node leaf ranges (DFS order), so
`refit_lbvh`'s RMQ refit and `sah_cost` work unchanged on SAH topologies.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from .lbvh import LBVH
from ..types import Mesh


def cpu_bvh_to_lbvh(cpu, mesh: Mesh, leaf_size: int) -> LBVH:
    """CpuBVH (DFS + skip links, variable leaf counts) -> LBVH arrays with
    fixed ``leaf_size`` (leaves repeat-pad their last triangle)."""
    n = cpu.bb_min.shape[0]
    is_leaf = cpu.prim_count > 0
    left = np.arange(n, dtype=np.int64) + 1
    right = cpu.skip[np.clip(left, 0, n - 1)].astype(np.int64)
    int_ids = np.cumsum(~is_leaf) - 1
    leaf_ids = np.cumsum(is_leaf) - 1
    nl = int(is_leaf.sum())
    ni = int((~is_leaf).sum())
    assert ni >= 1, "degenerate SAH tree (single leaf) unsupported"

    def ref_of(node):
        node = np.clip(node, 0, n - 1)
        return np.where(is_leaf[node], -(leaf_ids[node] + 1),
                        int_ids[node]).astype(np.int32)

    internal = ~is_leaf
    child = np.stack([ref_of(left), ref_of(right)], axis=1)[internal]
    lb = np.clip(left, 0, n - 1)[internal]
    rb = np.clip(right, 0, n - 1)[internal]
    nodes_box = np.concatenate(
        [cpu.bb_min[lb], cpu.bb_max[lb], cpu.bb_min[rb], cpu.bb_max[rb]],
        axis=1).astype(np.float32)

    # Leaf ranges per internal node (DFS order => every subtree's leaves
    # are contiguous): first = #leaves before node i, last = #leaves
    # before skip[i] - 1. Feeds RMQ refit + sah_cost unchanged.
    leaves_before = np.concatenate([[0], np.cumsum(is_leaf)])
    first = leaves_before[np.arange(n)][internal].astype(np.int32)
    last = (leaves_before[np.clip(cpu.skip, 0, n)][internal] - 1
            ).astype(np.int32)

    # Fixed-size leaves: repeat-pad each leaf's triangle run to leaf_size.
    starts = cpu.prim_start[is_leaf].astype(np.int64)
    counts = cpu.prim_count[is_leaf].astype(np.int64)
    k = leaf_size
    slot = np.tile(np.arange(k, dtype=np.int64), nl)
    base = np.repeat(starts, k)
    cnt = np.repeat(counts, k)
    tri_rows = cpu.tri_order[base + np.minimum(slot, cnt - 1)]

    v = np.asarray(mesh.vertices, np.float32)
    tri = np.asarray(mesh.indices, np.int64)[tri_rows]
    v0 = v[tri[:, 0]]
    e1 = v[tri[:, 1]] - v0
    e2 = v[tri[:, 2]] - v0
    return LBVH(nodes_box=jnp.asarray(nodes_box),
                nodes_child=jnp.asarray(child),
                nodes_first=jnp.asarray(first),
                nodes_last=jnp.asarray(last),
                tri_v0=jnp.asarray(v0), tri_e1=jnp.asarray(e1),
                tri_e2=jnp.asarray(e2),
                tri_sorted=jnp.asarray(tri.astype(np.int32)),
                tri_id=jnp.asarray(tri_rows.astype(np.int32)),
                root_min=jnp.asarray(cpu.bb_min[0]),
                root_max=jnp.asarray(cpu.bb_max[0]),
                leaf_size=k)


# Cache-key tag for the static-accel builder configuration: bump when the
# native builder's defaults change so content-addressed BVH caches miss.
SAH_VARIANT = "sbvh-a1e4-b1.2-3ax"


def build_sah_lbvh(mesh: Mesh, leaf_size: int = 14,
                   spatial_alpha: float | None = 1e-4,
                   spatial_budget: float = 1.2) -> Optional[LBVH]:
    """Native SAH/SBVH build for a static scene, in LBVH layout; None if
    the native library is unavailable (callers fall back to build_lbvh).

    Defaults to SBVH spatial splits (Stich et al. 2009 style; chopped
    binning, clipped-reference duplication capped at ``spatial_budget`` x
    num_tris): spatial splits collapse the long thin-triangle overlap
    chains that dominate traversal on the Sponza-class scene family.
    spatial_alpha=None selects the object-only build."""
    from ..native import build_sah_bvh
    cpu = build_sah_bvh(np.asarray(mesh.vertices, np.float32),
                        np.asarray(mesh.indices, np.int32),
                        leaf_size=leaf_size, spatial_alpha=spatial_alpha,
                        spatial_budget=spatial_budget)
    if cpu is None:
        return None
    return cpu_bvh_to_lbvh(cpu, mesh, leaf_size)
