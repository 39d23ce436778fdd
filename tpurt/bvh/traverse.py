"""Plain-XLA BVH traversal: vmapped per-ray stack walks.

Two walks live here:

- ``traverse`` walks the binary LBVH (two children per node).
- ``traverse_wide`` walks the 8-wide ``WideBVH`` rows (bvh/wide.py). It is
  the plain twin of the CUDA kernel in tpurt/kernels/traverse.py: same
  row layout, same slab test, same empty-slot rule, same Möller–Trumbore.
  It is the reference the kernel is checked against on the card, and the
  route every CPU run takes.

Semantics match the reference compute shader's ``castShadowRay`` loop
(Source/Shaders/RayTracedShadows.comp [RECALL]): slab test against child
boxes, Möller–Trumbore at leaves (two-sided), any-hit early-out for shadow
rays; closest-hit mode drives the G-buffer pass.

The binary walk's stack of 128 is provably sufficient: the Karras delta
strictly increases along any root->leaf path and is bounded by 60 code bits
+ 32 tiebreak bits (see tpurt/bvh/lbvh.py docstring). The wide walk's stack
is sized from the tree when the accel is built (bvh/wide.size_stack) and
checked besides: a walk that overflows it or passes its iteration cap is
counted as an error, never returned as a silent miss.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .lbvh import LBVH

STACK_DEPTH = 128


def ray_box_interval(o, inv_d, bmin, bmax, t_min, t_max):
    """Vectorized slab test -> (enter, hit). NaNs from 0*inf resolved to the
    conservative (hit-permissive) side, matching the oracle."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    lo = jnp.where(jnp.isnan(lo), -jnp.inf, lo)
    hi = jnp.where(jnp.isnan(hi), jnp.inf, hi)
    enter = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    exit_ = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    return enter, enter <= exit_


def moller_trumbore_t(o, d, v0, e1, e2, eps=1e-9):
    """Batched two-sided Möller–Trumbore; returns t (+inf on miss).

    o, d: [..., 3]; v0/e1/e2 broadcastable to [..., 3].
    """
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) < eps, 0.0, 1.0 / det)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok = ((jnp.abs(det) >= eps) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0))
    return jnp.where(ok, t, jnp.inf)


def _traverse_one(bvh: LBVH, any_hit: bool, t_min, o, d, t_max):
    """Single-ray stack traversal (vmapped by the caller)."""
    k = bvh.leaf_size
    inv_d = 1.0 / d  # +/-inf on zero components; slab test resolves the NaNs

    def leaf_hits(leaf_id, best_t, best_id):
        if bvh.leaf_block is not None:
            # Sub-leaf clustered tree: the tree-leaf's triangle content
            # is its whole parent block (lbvh.LBVH docstring).
            leaf_id = bvh.leaf_block[leaf_id]
        base = leaf_id * k
        v0 = jax.lax.dynamic_slice(bvh.tri_v0, (base, 0), (k, 3))
        e1 = jax.lax.dynamic_slice(bvh.tri_e1, (base, 0), (k, 3))
        e2 = jax.lax.dynamic_slice(bvh.tri_e2, (base, 0), (k, 3))
        ids = jax.lax.dynamic_slice(bvh.tri_id, (base,), (k,))
        t = moller_trumbore_t(o[None, :], d[None, :], v0, e1, e2)
        t = jnp.where((t > t_min) & (t < best_t), t, jnp.inf)
        j = jnp.argmin(t)
        better = t[j] < best_t
        return (jnp.where(better, t[j], best_t),
                jnp.where(better, ids[j], best_id))

    def body(state):
        stack, sp, best_t, best_id = state
        sp = sp - 1
        node = stack[sp]
        row = bvh.nodes_box[node]
        children = bvh.nodes_child[node]

        def visit_child(c, bmin, bmax, carry):
            stack, sp, best_t, best_id = carry
            _, hit = ray_box_interval(o, inv_d, bmin, bmax, t_min, best_t)
            is_leaf = c < 0
            leaf_id = jnp.maximum(-c - 1, 0)
            lt, lid = leaf_hits(leaf_id, best_t, best_id)
            take_leaf = hit & is_leaf
            best_t = jnp.where(take_leaf, lt, best_t)
            best_id = jnp.where(take_leaf, lid, best_id)
            push = hit & ~is_leaf
            stack = stack.at[sp].set(jnp.where(push, c, stack[sp]))
            sp = sp + push.astype(jnp.int32)
            return stack, sp, best_t, best_id

        carry = (stack, sp, best_t, best_id)
        carry = visit_child(children[0], row[0:3], row[3:6], carry)
        carry = visit_child(children[1], row[6:9], row[9:12], carry)
        return carry

    def cond(state):
        _, sp, _, best_id = state
        alive = sp > 0
        if any_hit:
            alive = alive & (best_id < 0)
        return alive

    # Derive while-carry inits from the ray so they inherit its sharding
    # varying-ness: under shard_map(check_vma=True) a replicated-constant
    # init would mismatch the varying carry the body produces.
    zf = o[0] * 0.0
    zi = zf.astype(jnp.int32)
    stack0 = jnp.zeros((STACK_DEPTH,), jnp.int32) + zi
    init = (stack0, jnp.int32(1) + zi,
            jnp.asarray(t_max, jnp.float32) + zf, jnp.int32(-1) + zi)
    _, _, best_t, best_id = jax.lax.while_loop(cond, body, init)
    best_t = jnp.where(best_id >= 0, best_t, jnp.inf)
    return best_t, best_id


@partial(jax.jit, static_argnames=("any_hit", "chunk"))
def traverse(bvh: LBVH, origins: jnp.ndarray, dirs: jnp.ndarray,
             t_min: float = 0.0, t_max=jnp.inf, any_hit: bool = False,
             chunk: int = 16384) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Trace rays against the LBVH.

    origins/dirs: f32[..., 3]; t_max: scalar or [...] per-ray.
    Returns (t f32[...], tri_id i32[...]); misses are (inf, -1). With
    any_hit=True the t is *a* hit, not necessarily the closest — all the
    shadow pass needs (reference any-hit early-out semantics).

    Rays are processed in ``chunk``-sized blocks (see _chunked_map).
    """
    shape, n, o, d, tmax_arr = _flatten_rays(origins, dirs, t_max, chunk)
    one = jax.vmap(partial(_traverse_one, bvh, any_hit, t_min))
    t, tid = _chunked_map(one, o, d, tmax_arr, chunk)
    return t[:n].reshape(shape), tid[:n].reshape(shape)


def _flatten_rays(origins, dirs, t_max, chunk: int):
    """(..., 3) rays + scalar or per-ray t_max -> flat arrays padded to a
    multiple of ``chunk`` (padding rays have t_max = 0: inactive)."""
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n = o.shape[0]
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), shape).reshape(-1)
    npad = ((n + chunk - 1) // chunk) * chunk
    if npad != n:
        o = jnp.concatenate([o, jnp.zeros((npad - n, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.ones((npad - n, 3), d.dtype)])
        tm = jnp.concatenate([tm, jnp.zeros(npad - n, jnp.float32)])
    return shape, n, o, d, tm


def _chunked_map(one, o, d, tm, chunk: int):
    """Apply the vmapped walk ``one`` in ``chunk``-ray blocks (lax.map), so
    live memory stays O(chunk * stack) regardless of resolution — the
    long-axis blocking strategy from SURVEY.md §5."""
    if o.shape[0] == chunk:
        return one(o, d, tm)
    res = jax.lax.map(lambda args: one(*args),
                      (o.reshape(-1, chunk, 3), d.reshape(-1, chunk, 3),
                       tm.reshape(-1, chunk)))
    return tuple(r.reshape(-1) for r in res)


# Wide walk: the clamp that keeps slab products NaN-free (0 * 3.4e38 = 0,
# where 0 * inf would be NaN). The CUDA kernel uses the same clamp, so both
# resolve axis-parallel rays identically. The per-ray stack holds
# ``wide.stack_depth`` entries, sized from the tree (bvh/wide.size_stack).
_BIG = 3.4e38


def wide_iteration_cap(num_wide: int) -> int:
    """Upper bound on the wide walk's pops for a tree of ``num_wide`` rows:
    each node is pushed at most once per ray, and each pushes at most 8
    entries (nodes or leaves). A walk past it is corrupt."""
    return 9 * num_wide + 64


def _wide_walk_one(wide, any_hit: bool, t_min, o, d, t_max):
    """Single-ray walk over WideBVH rows (vmapped by the caller).

    Both internal nodes and leaves are stack entries (leaf l as -(l+1), the
    row encoding): each iteration pops one entry and either tests its k
    triangles or slab-tests its 8 child slots. Hit children are pushed
    farthest-first, so the nearest pops next and ``best_t`` culls the rest.
    Returns (t, sorted triangle index, error flag)."""
    k = wide.leaf_size
    depth = wide.stack_depth
    cap = wide_iteration_cap(wide.num_wide)
    inv = jnp.clip(1.0 / d, -_BIG, _BIG)
    slots = jnp.arange(8, dtype=jnp.int32)

    def body(state):
        stack, sp, best_t, best_i, it, err = state
        sp = sp - 1
        ref = stack[sp]
        is_leaf = ref < 0
        # Leaf entry: Möller–Trumbore over the row's k triangles.
        leaf = jnp.maximum(-ref - 1, 0)
        tri = wide.tris[leaf, :9 * k].reshape(k, 3, 3)
        t = moller_trumbore_t(o[None, :], d[None, :], tri[:, 0], tri[:, 1],
                              tri[:, 2])
        t = jnp.where((t > t_min) & (t < best_t), t, jnp.inf)
        j = jnp.argmin(t)
        better = is_leaf & (t[j] < best_t)
        best_t = jnp.where(better, t[j], best_t)
        best_i = jnp.where(better, leaf * k + j.astype(jnp.int32), best_i)
        # Node entry: slab test all 8 slots; inverted (empty) boxes never
        # count as hit, whatever the slab arithmetic says.
        rec = wide.nodes[jnp.maximum(ref, 0)].reshape(8, 16)
        bmin, bmax = rec[:, 0:3], rec[:, 3:6]
        t0 = (bmin - o) * inv
        t1 = (bmax - o) * inv
        enter = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), t_min)
        exit_ = jnp.minimum(jnp.min(jnp.maximum(t0, t1), axis=-1), best_t)
        hit = (~is_leaf) & (enter <= exit_) & (bmin[:, 0] <= bmax[:, 0])
        # Farthest first, misses last; push the hits on top of the stack.
        perm = jnp.argsort(jnp.where(hit, -enter, jnp.inf))
        nhit = jnp.sum(hit.astype(jnp.int32))
        pos = jnp.where(slots < nhit, sp + slots, depth)
        pos = jnp.where(pos < depth, pos, depth)
        stack = stack.at[pos].set(rec[perm, 6].astype(jnp.int32),
                                  mode="drop")
        err = err | (sp + nhit > depth)
        sp = jnp.minimum(sp + nhit, depth)
        return stack, sp, best_t, best_i, it + 1, err

    def cond(state):
        _, sp, _, best_i, it, _ = state
        alive = (sp > 0) & (it < cap)
        if any_hit:
            alive = alive & (best_i < 0)
        return alive

    # Carry inits derive from the ray so they inherit its sharding
    # varying-ness under shard_map(check_vma=True).
    zf = o[0] * 0.0
    zi = zf.astype(jnp.int32)
    active = t_max > t_min
    init = (jnp.zeros((depth,), jnp.int32) + zi,
            active.astype(jnp.int32) + zi, t_max + zf, jnp.int32(-1) + zi,
            zi, zi > 0)
    _, sp, best_t, best_i, it, err = jax.lax.while_loop(cond, body, init)
    # Out of iterations with work left (and, for any-hit, nothing found).
    unfinished = (sp > 0) & (it >= cap)
    if any_hit:
        unfinished = unfinished & (best_i < 0)
    best_t = jnp.where(best_i >= 0, best_t, jnp.inf)
    return best_t, best_i, err | unfinished


@partial(jax.jit, static_argnames=("any_hit", "chunk"))
def traverse_wide(wide, origins: jnp.ndarray, dirs: jnp.ndarray,
                  t_min: float = 0.0, t_max=jnp.inf, any_hit: bool = False,
                  chunk: int = 16384):
    """Trace rays against a ``WideBVH`` in plain XLA.

    origins/dirs: f32[..., 3]; t_max: scalar or [...] per-ray (rays with
    t_max <= t_min are inactive and miss). Returns (t f32[...], sorted
    triangle index i32[...], errors i32[]): misses are (inf, -1); the
    index keys the sorted-order tables (``wide.tri_id``, the shade table);
    ``errors`` counts rays whose walk overflowed the stack or hit the
    iteration cap. With any_hit=True the t is *a* hit, not necessarily the
    closest.
    """
    shape, n, o, d, tm = _flatten_rays(origins, dirs, t_max, chunk)
    one = jax.vmap(partial(_wide_walk_one, wide, any_hit, t_min))
    t, sidx, err = _chunked_map(one, o, d, tm, chunk)
    errors = jnp.sum(err[:n].astype(jnp.int32))
    return t[:n].reshape(shape), sidx[:n].reshape(shape), errors
