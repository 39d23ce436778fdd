"""Ray sorting + stream compaction (BASELINE config 5).

Incoherent shadow-ray batches (many lights, jittered area samples) scatter
neighbouring rays across the BVH; sorting rays by (direction octant, Morton
code of origin) re-clusters them so neighbouring rays traverse a compact
node set. Invalid/sky rays sort to the end, so trailing warps are entirely
inactive and exit at once — stream compaction under XLA's static shapes
(SURVEY.md §7 hard part 4: sort by predicate with padded capacity instead
of dynamic shapes).

The reference has no analogue; cf. "On Ray Reordering Techniques for Faster
GPU Ray Tracing" (PAPERS.md).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..bvh.morton import morton_of_points


def ray_sort_keys(origins: jnp.ndarray, dirs: jnp.ndarray,
                  t_max: jnp.ndarray, scene_min, scene_max) -> jnp.ndarray:
    """uint32 sort key per ray: [1 bit invalid][3 bits octant][27 bits Morton].

    Lower = traced earlier; invalid rays (t_max <= 0) get the top bit so they
    cluster at the end.
    """
    octant = ((dirs[..., 0] < 0).astype(jnp.uint32)
              | ((dirs[..., 1] < 0).astype(jnp.uint32) << 1)
              | ((dirs[..., 2] < 0).astype(jnp.uint32) << 2))
    morton = morton_of_points(origins, scene_min, scene_max) >> jnp.uint32(3)
    key = (octant << jnp.uint32(27)) | morton
    invalid = (t_max <= 0.0).astype(jnp.uint32)
    return key | (invalid << jnp.uint32(31))


def sort_rays(origins: jnp.ndarray, dirs: jnp.ndarray, t_max: jnp.ndarray,
              scene_min, scene_max
              ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Flatten + coherence-sort rays. Returns (o, d, t_max, perm) where
    ``perm`` maps sorted position -> original flat index."""
    flat_o = origins.reshape(-1, 3)
    flat_d = dirs.reshape(-1, 3)
    flat_t = t_max.reshape(-1)
    keys = ray_sort_keys(flat_o, flat_d, flat_t, scene_min, scene_max)
    perm = jnp.argsort(keys)
    return flat_o[perm], flat_d[perm], flat_t[perm], perm


def unsort(values: jnp.ndarray, perm: jnp.ndarray, shape) -> jnp.ndarray:
    """Scatter sorted-order results back to the original ray order/shape."""
    out = jnp.zeros((perm.shape[0],) + values.shape[1:], values.dtype)
    out = out.at[perm].set(values)
    return out.reshape(shape)


def compaction_stats(t_max: jnp.ndarray, packet: int = 1024):
    """Occupancy metrics for observability (SURVEY.md §5): fraction of
    packets that are fully inactive after sorting (skipped outright)."""
    flat = t_max.reshape(-1)
    n = flat.shape[0]
    npad = -(-n // packet) * packet
    flat = jnp.concatenate([flat, jnp.full((npad - n,), -1.0, flat.dtype)])
    active = (flat > 0).reshape(-1, packet)
    per_packet = active.sum(axis=1)
    return {
        "packets": npad // packet,
        "empty_packets": jnp.sum(per_packet == 0),
        "mean_occupancy": jnp.mean(per_packet / packet),
    }


def make_sorted_tracer(trace_any: Callable, scene_min, scene_max) -> Callable:
    """Wrap an occlusion tracer ((o, d, t_max) -> (occluded, errors)) with
    sort -> trace -> unsort."""

    def traced(origins, dirs, t_max):
        shape = t_max.shape
        o, d, tm, perm = sort_rays(origins, dirs,
                                   jnp.broadcast_to(t_max, shape),
                                   scene_min, scene_max)
        occ, errors = trace_any(o, d, tm)
        return unsort(occ, perm, shape), errors

    return traced
