"""Stage-2 tests: the NumPy CPU oracle (brute force + recursive BVH).

The BVH-vs-brute-force agreement here is the root of the whole test pyramid:
every JAX path is later validated against these oracles, mirroring
the reference's compute-vs-NV-hardware cross-check (SURVEY.md §4).
"""

import numpy as np
import pytest

from tpurt.bvh.reference import (CpuBVH, brute_force_any, brute_force_closest,
                                 build_cpu_bvh, cpu_bvh_traverse,
                                 moller_trumbore, ray_aabb, triangle_data)
from tpurt.scenes import make_box, make_sphere, random_soup, teapot_scene


# ---------------------------------------------------------------------------
# Scalar primitive edge cases
# ---------------------------------------------------------------------------

def test_mt_basic_hit():
    t = moller_trumbore(np.array([0.2, 0.2, 1.0]), np.array([0., 0., -1.]),
                        np.array([0., 0., 0.]), np.array([1., 0., 0.]),
                        np.array([0., 1., 0.]))
    assert np.isclose(t, 1.0)


def test_mt_backface_hits():
    # Two-sided: hit from behind also counts (shadow semantics).
    t = moller_trumbore(np.array([0.2, 0.2, -1.0]), np.array([0., 0., 1.]),
                        np.array([0., 0., 0.]), np.array([1., 0., 0.]),
                        np.array([0., 1., 0.]))
    assert np.isclose(t, 1.0)


def test_mt_miss_outside_barycentric():
    t = moller_trumbore(np.array([0.9, 0.9, 1.0]), np.array([0., 0., -1.]),
                        np.array([0., 0., 0.]), np.array([1., 0., 0.]),
                        np.array([0., 1., 0.]))
    assert np.isinf(t)


def test_mt_parallel_ray_misses():
    t = moller_trumbore(np.array([0.2, 0.2, 1.0]), np.array([1., 0., 0.]),
                        np.array([0., 0., 0.]), np.array([1., 0., 0.]),
                        np.array([0., 1., 0.]))
    assert np.isinf(t)


def test_mt_respects_t_range():
    o = np.array([0.2, 0.2, 1.0])
    d = np.array([0., 0., -1.])
    v0 = np.array([0., 0., 0.])
    e1 = np.array([1., 0., 0.])
    e2 = np.array([0., 1., 0.])
    assert np.isinf(moller_trumbore(o, d, v0, e1, e2, t_max=0.5))
    assert np.isinf(moller_trumbore(o, d, v0, e1, e2, t_min=1.5))


def test_aabb_axis_parallel_inf():
    o = np.array([0.5, 0.5, -1.0])
    d = np.array([0.0, 0.0, 1.0])
    with np.errstate(divide="ignore"):
        inv = 1.0 / d
    assert ray_aabb(o, inv, np.zeros(3), np.ones(3))
    # origin on the slab boundary (0 * inf -> NaN path)
    o2 = np.array([0.0, 0.0, -1.0])
    assert ray_aabb(o2, inv, np.zeros(3), np.ones(3))
    # outside the slab
    o3 = np.array([2.0, 0.5, -1.0])
    assert not ray_aabb(o3, inv, np.zeros(3), np.ones(3))


def test_aabb_behind_ray():
    o = np.array([0.5, 0.5, 2.0])
    d = np.array([0.0, 0.0, 1.0])  # pointing away
    with np.errstate(divide="ignore"):
        inv = 1.0 / d
    assert not ray_aabb(o, inv, np.zeros(3), np.ones(3))


# ---------------------------------------------------------------------------
# BVH structure invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["median", "sah"])
def test_cpu_bvh_invariants(method):
    mesh = random_soup(200, seed=3)
    bvh = build_cpu_bvh(mesh, leaf_size=4, method=method)
    n = bvh.num_nodes
    # Root box contains all triangles.
    v0, e1, e2 = triangle_data(mesh)
    tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2).min(axis=0)
    tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2).max(axis=0)
    assert (bvh.bb_min[0] <= tmin + 1e-5).all()
    assert (bvh.bb_max[0] >= tmax - 1e-5).all()
    # Leaves cover every triangle exactly once via tri_order.
    covered = np.zeros(mesh.num_triangles, bool)
    for i in range(n):
        c = bvh.prim_count[i]
        if c > 0:
            ids = bvh.tri_order[bvh.prim_start[i]: bvh.prim_start[i] + c]
            assert not covered[ids].any()
            covered[ids] = True
    assert covered.all()
    # Skip links are monotone and in range.
    assert (bvh.skip > np.arange(n)).all()
    assert (bvh.skip <= n).all()
    # Parent boxes contain children (walk depth-first ranges).
    for i in range(n):
        if bvh.prim_count[i] == 0:
            left = i + 1
            right = bvh.skip[left]
            for ch in (left, right):
                assert (bvh.bb_min[i] <= bvh.bb_min[ch] + 1e-6).all()
                assert (bvh.bb_max[i] >= bvh.bb_max[ch] - 1e-6).all()


# ---------------------------------------------------------------------------
# Traversal agreement with brute force
# ---------------------------------------------------------------------------

def _random_rays(rng, n, extent=12.0):
    o = rng.uniform(-extent, extent, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("method", ["median", "sah"])
def test_bvh_matches_brute_force_closest(method, rng):
    mesh = random_soup(150, seed=11)
    bvh = build_cpu_bvh(mesh, leaf_size=3, method=method)
    o, d = _random_rays(rng, 64)
    bt, bid = brute_force_closest(mesh, o, d)
    tt, tid = cpu_bvh_traverse(bvh, mesh, o, d)
    np.testing.assert_allclose(tt, bt, rtol=1e-6, atol=1e-9)
    # ids may differ only when two triangles are hit at the same t
    diff = tid != bid
    if diff.any():
        assert np.allclose(tt[diff], bt[diff])


def test_bvh_any_hit_matches(rng):
    mesh = teapot_scene(4000)
    bvh = build_cpu_bvh(mesh, leaf_size=4)
    o, d = _random_rays(rng, 48, extent=8.0)
    want = brute_force_any(mesh, o, d)
    t, tid = cpu_bvh_traverse(bvh, mesh, o, d, any_hit=True)
    got = tid >= 0
    np.testing.assert_array_equal(got, want)


def test_bvh_t_range(rng):
    mesh = random_soup(80, seed=5)
    bvh = build_cpu_bvh(mesh)
    o, d = _random_rays(rng, 32)
    want = brute_force_any(mesh, o, d, t_min=1e-3, t_max=4.0)
    t, tid = cpu_bvh_traverse(bvh, mesh, o, d, t_min=1e-3, t_max=4.0,
                              any_hit=True)
    np.testing.assert_array_equal(tid >= 0, want)
