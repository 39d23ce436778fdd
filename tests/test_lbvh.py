"""Stage-4 tests: Morton codes, Karras topology, RMQ boxes, JAX traversal,
refit — validated against the NumPy oracle (SURVEY.md §4.2/4.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh.lbvh import (LBVH, build_lbvh, karras_topology, range_boxes,
                            refit_lbvh, sah_cost)
from tpurt.bvh.morton import (compact_bits_10, expand_bits_10, morton_decode,
                              morton_encode, quantize_points)
from tpurt.bvh.reference import brute_force_any, brute_force_closest
from tpurt.bvh.traverse import moller_trumbore_t, ray_box_interval, traverse
from tpurt.scenes import deform, random_soup, teapot_scene


# ---------------------------------------------------------------------------
# Morton
# ---------------------------------------------------------------------------

def test_morton_roundtrip():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 1024, (256, 3)).astype(np.uint32)
    code = morton_encode(jnp.asarray(q))
    back = morton_decode(code)
    np.testing.assert_array_equal(np.asarray(back), q)


def test_morton_locality_order():
    # Codes of points along a diagonal must be sorted.
    pts = jnp.stack([jnp.linspace(0, 1, 32)] * 3, axis=-1) * 1000
    q = quantize_points(pts, jnp.zeros(3), jnp.full((3,), 1000.0))
    codes = np.asarray(morton_encode(q))
    assert (np.diff(codes.astype(np.int64)) >= 0).all()


def test_expand_compact_inverse():
    v = jnp.arange(1024, dtype=jnp.uint32)
    np.testing.assert_array_equal(np.asarray(compact_bits_10(expand_bits_10(v))),
                                  np.asarray(v))


# ---------------------------------------------------------------------------
# Karras topology invariants
# ---------------------------------------------------------------------------

def _check_topology(child, first, last, n_leaves):
    child = np.asarray(child)
    first = np.asarray(first)
    last = np.asarray(last)
    ni = n_leaves - 1
    assert child.shape == (ni, 2)
    # Root covers everything.
    assert first[0] == 0 and last[0] == n_leaves - 1
    # Every node's children partition its range.
    seen_leaf = np.zeros(n_leaves, int)
    seen_internal = np.zeros(ni, int)

    def span(c):
        if c < 0:
            leaf = -c - 1
            seen_leaf[leaf] += 1
            return leaf, leaf
        seen_internal[c] += 1
        return first[c], last[c]

    for i in range(ni):
        lf, ll = span(child[i, 0])
        rf, rl = span(child[i, 1])
        assert lf == first[i] and rl == last[i], f"node {i} range mismatch"
        assert ll + 1 == rf, f"node {i} children not adjacent"
    # Every leaf referenced exactly once; every internal node except the root
    # referenced exactly once.
    assert (seen_leaf == 1).all()
    assert seen_internal[0] == 0
    assert (seen_internal[1:] == 1).all()


@pytest.mark.parametrize("n", [2, 3, 5, 16, 33, 100])
def test_karras_random_codes(n):
    rng = np.random.default_rng(n)
    codes = jnp.asarray(rng.integers(0, 2 ** 30, n).astype(np.uint32))
    codes = jnp.sort(codes)
    child, first, last = karras_topology(codes)
    _check_topology(child, first, last, n)


def test_karras_all_equal_codes():
    # Degenerate scene: all centroids identical. Index tiebreak must still
    # produce a valid (and balanced) tree.
    n = 64
    codes = jnp.full((n,), 12345, jnp.uint32)
    child, first, last = karras_topology(codes)
    _check_topology(child, first, last, n)
    # Balanced: range length halves -> max depth ~ log2(n). Verify via ranges.
    lengths = np.asarray(last) - np.asarray(first) + 1
    assert lengths.max() == n


def test_karras_matches_sorted_structure():
    # Leaves 0..n-1 with strictly increasing codes of varying prefix.
    codes = jnp.asarray(np.array([0b000, 0b001, 0b010, 0b100, 0b101, 0b111],
                                 np.uint32))
    child, first, last = karras_topology(codes)
    _check_topology(child, first, last, 6)


# ---------------------------------------------------------------------------
# RMQ
# ---------------------------------------------------------------------------

def test_range_boxes_matches_numpy():
    rng = np.random.default_rng(3)
    n = 37
    lmin = rng.uniform(-5, 0, (n, 3)).astype(np.float32)
    lmax = lmin + rng.uniform(0, 3, (n, 3)).astype(np.float32)
    q = 50
    first = rng.integers(0, n, q)
    last = np.array([rng.integers(f, n) for f in first])
    got_min, got_max = range_boxes(jnp.asarray(lmin), jnp.asarray(lmax),
                                   jnp.asarray(first.astype(np.int32)),
                                   jnp.asarray(last.astype(np.int32)))
    for i in range(q):
        np.testing.assert_allclose(np.asarray(got_min)[i],
                                   lmin[first[i]:last[i] + 1].min(0), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(got_max)[i],
                                   lmax[first[i]:last[i] + 1].max(0), rtol=1e-6)


# ---------------------------------------------------------------------------
# Full build invariants + traversal agreement
# ---------------------------------------------------------------------------

def _build(mesh, leaf_size=4):
    return build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                      leaf_size=leaf_size)


def test_build_boxes_contain_children():
    mesh = random_soup(300, seed=9)
    bvh = _build(mesh)
    box = np.asarray(bvh.nodes_box)
    child = np.asarray(bvh.nodes_child)
    first = np.asarray(bvh.nodes_first)
    last = np.asarray(bvh.nodes_last)
    # Parent covering range must contain child boxes.
    for i in range(len(child)):
        pmin = np.minimum(box[i, 0:3], box[i, 6:9])
        pmax = np.maximum(box[i, 3:6], box[i, 9:12])
        for side, c in enumerate(child[i]):
            cmin = box[i, 0:3] if side == 0 else box[i, 6:9]
            cmax = box[i, 3:6] if side == 0 else box[i, 9:12]
            assert (pmin <= cmin + 1e-5).all()
            assert (pmax >= cmax - 1e-5).all()
            if c >= 0:
                # Internal child's own children stay inside this box.
                ccmin = np.minimum(box[c, 0:3], box[c, 6:9])
                ccmax = np.maximum(box[c, 3:6], box[c, 9:12])
                assert (cmin <= ccmin + 1e-5).all()
                assert (cmax >= ccmax - 1e-5).all()


def test_build_sorted_tris_cover_all():
    mesh = random_soup(123, seed=2)  # not a multiple of leaf size -> padding
    bvh = _build(mesh, leaf_size=4)
    ids = np.asarray(bvh.tri_id)
    assert bvh.num_sorted_tris % 4 == 0
    assert set(ids.tolist()) == set(range(123))


@pytest.mark.parametrize(
    "nt,seed", [(64, 0), pytest.param(150, 1, marks=pytest.mark.slow),
                (501, 2)])
def test_traverse_closest_matches_brute(nt, seed, rng):
    mesh = random_soup(nt, seed=seed)
    bvh = _build(mesh)
    o = rng.uniform(-8, 8, (96, 3)).astype(np.float32)
    d = rng.normal(size=(96, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want_t, want_id = brute_force_closest(mesh, o, d)
    got_t, got_id = traverse(bvh, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(got_t), want_t, rtol=2e-4, atol=1e-6)


def test_traverse_any_hit_matches_brute(rng):
    mesh = teapot_scene(3000)
    bvh = _build(mesh)
    o = rng.uniform(-6, 6, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = brute_force_any(mesh, o, d, t_min=1e-4)
    _, got_id = traverse(bvh, jnp.asarray(o), jnp.asarray(d), t_min=1e-4,
                         any_hit=True)
    np.testing.assert_array_equal(np.asarray(got_id) >= 0, want)


def test_traverse_respects_per_ray_tmax(rng):
    mesh = random_soup(100, seed=4)
    bvh = _build(mesh)
    o = rng.uniform(-8, 8, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_full, _ = traverse(bvh, jnp.asarray(o), jnp.asarray(d))
    tmax = np.where(np.isfinite(np.asarray(t_full)),
                    np.asarray(t_full) * 0.99, 1.0).astype(np.float32)
    t_cut, tid_cut = traverse(bvh, jnp.asarray(o), jnp.asarray(d),
                              t_max=jnp.asarray(tmax))
    # Closest hit now excluded -> either miss or strictly larger t... but a
    # *different* triangle at t < tmax may exist; all hits must obey tmax.
    got = np.asarray(t_cut)
    assert (got[np.isfinite(got)] < tmax[np.isfinite(got)]).all()


def test_traverse_axis_parallel_rays():
    mesh = teapot_scene(1000)
    bvh = _build(mesh)
    # Straight-down rays (two zero direction components).
    o = np.array([[0.0, 8.0, 0.0], [-2.6, 8.0, 1.8]], np.float32)
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (2, 1))
    want_t, _ = brute_force_closest(mesh, o, d)
    got_t, _ = traverse(bvh, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(got_t), want_t, rtol=1e-5)


def test_chunked_equals_unchunked(rng):
    mesh = random_soup(80, seed=8)
    bvh = _build(mesh)
    o = rng.uniform(-8, 8, (100, 3)).astype(np.float32)
    d = rng.normal(size=(100, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t1, id1 = traverse(bvh, jnp.asarray(o), jnp.asarray(d), chunk=32)
    t2, id2 = traverse(bvh, jnp.asarray(o), jnp.asarray(d), chunk=16384)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(id1), np.asarray(id2))


# ---------------------------------------------------------------------------
# Refit (config 4)
# ---------------------------------------------------------------------------

def test_refit_matches_fresh_build_results(rng):
    mesh = teapot_scene(2000)
    bvh = _build(mesh)
    new_verts = deform(mesh, time=0.7)
    refit = refit_lbvh(bvh, jnp.asarray(new_verts), jnp.asarray(mesh.indices))
    # Refit boxes must remain valid: traversal results == brute force on the
    # deformed mesh.
    import dataclasses
    moved = dataclasses.replace(mesh, vertices=new_verts)
    o = rng.uniform(-6, 6, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want_t, _ = brute_force_closest(moved, o, d)
    got_t, _ = traverse(refit, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(got_t), want_t, rtol=2e-4, atol=1e-6)


def test_refit_cost_degrades_vs_rebuild():
    mesh = teapot_scene(2000)
    bvh = _build(mesh)
    c0 = float(sah_cost(bvh))
    new_verts = deform(mesh, time=2.0, amplitude=1.5)
    refit = refit_lbvh(bvh, jnp.asarray(new_verts), jnp.asarray(mesh.indices))
    rebuilt = build_lbvh(jnp.asarray(new_verts), jnp.asarray(mesh.indices))
    c_refit = float(sah_cost(refit))
    c_rebuild = float(sah_cost(rebuilt))
    assert c_refit >= c_rebuild * 0.99  # refit never beats a fresh build
    assert c0 > 0 and np.isfinite(c_refit)


def test_build_under_jit_and_grad_free():
    mesh = random_soup(50, seed=1)
    f = jax.jit(lambda v, i: build_lbvh(v, i).nodes_box)
    out = f(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices))
    assert np.isfinite(np.asarray(out)).all()


def test_deferred_boxes_rebuild_bitexact():
    """build_lbvh(boxes="defer") + widen_lbvh must produce the EXACT same
    WideBVH as the full-box path: the deferred path answers every wide
    node's box straight from the RMQ sparse table, and min/max are exact
    in fp, so any mismatch is a real indexing bug."""
    from tpurt.bvh.wide import count_wide, round_up_bucket, widen_lbvh
    from tpurt.scenes import teapot_scene
    mesh = teapot_scene(2000)
    v = jnp.asarray(mesh.vertices)
    i = jnp.asarray(mesh.indices)
    full = build_lbvh(v, i, leaf_size=8)
    # Deferred builds carry no node boxes, so they can only collapse with
    # the "fixed" frontier; pin the full-box side to the same mode (the
    # default is "area", which picks a different — also valid — cut).
    nw_pad = round_up_bucket(max(count_wide(full, mode="fixed"), 1),
                             bucket=128)
    w_full = widen_lbvh(full, nw_pad=nw_pad, mode="fixed")
    defer = build_lbvh(v, i, leaf_size=8, boxes="defer")
    assert defer.nodes_box is None
    w_def = widen_lbvh(defer, nw_pad=nw_pad, mode="fixed")
    np.testing.assert_array_equal(np.asarray(w_full.nodes),
                                  np.asarray(w_def.nodes))
    np.testing.assert_array_equal(np.asarray(w_full.tris),
                                  np.asarray(w_def.tris))
    np.testing.assert_array_equal(np.asarray(w_full.tri_id),
                                  np.asarray(w_def.tri_id))
    np.testing.assert_array_equal(np.asarray(full.root_min),
                                  np.asarray(defer.root_min))
    np.testing.assert_array_equal(np.asarray(full.root_max),
                                  np.asarray(defer.root_max))
