"""Implicit 8-ary Morton BVH (tpurt/bvh/implicit.py): build/refit parity
against the brute-force oracle, corners-path equivalence, and layout
invariants. CPU, XLA wide walk (SURVEY.md §4.2 oracle strategy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh.implicit import (build_wide_implicit,
                                build_wide_implicit_corners,
                                expand_corners, level_sizes,
                                num_wide_implicit, refit_wide_implicit,
                                refit_wide_implicit_corners)
from tpurt.bvh.reference import brute_force_any, brute_force_closest
from tpurt.bvh.traverse import traverse_wide
from tpurt.scenes import deform, random_soup, teapot_scene


def trace_any_wide(wide, o, d, t_max):
    """Occlusion from the XLA wide walk (the CUDA kernel's plain twin)."""
    _, sidx, errors = traverse_wide(wide, o, d, t_max=t_max, any_hit=True)
    assert int(errors) == 0
    return sidx >= 0


def trace_closest_wide(wide, o, d):
    """(t, original tri_id) from the XLA wide walk."""
    t, sidx, errors = traverse_wide(wide, o, d)
    assert int(errors) == 0
    return t, jnp.where(sidx >= 0, wide.tri_id[jnp.maximum(sidx, 0)], -1)


def _rays_for(mesh, n=512, seed=3):
    rng = np.random.default_rng(seed)
    v = np.asarray(mesh.vertices)
    lo, hi = v.min(0), v.max(0)
    span = hi - lo
    o = rng.uniform(lo - 0.3 * span, hi + 0.3 * span, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32))


def test_level_sizes_and_counts():
    assert level_sizes(1) == [1]
    assert level_sizes(8) == [1]
    assert level_sizes(9) == [2, 1]
    assert level_sizes(64) == [8, 1]
    assert level_sizes(65) == [9, 2, 1]
    assert num_wide_implicit(65) == 12


@pytest.mark.parametrize("scene,leaf", [("soup", 4), ("soup", 14),
                                        ("teapot", 8)])
def test_implicit_any_hit_matches_oracle(scene, leaf):
    mesh = random_soup(700, seed=11) if scene == "soup" \
        else teapot_scene(2_000)
    wide = jax.jit(build_wide_implicit,
                   static_argnames=("leaf_size",))(
        mesh.vertices, mesh.indices, leaf_size=leaf)
    o, d = _rays_for(mesh)
    occ = trace_any_wide(wide, o, d, jnp.full(o.shape[0], 3.4e38))
    want = brute_force_any(mesh, np.asarray(o), np.asarray(d))
    np.testing.assert_array_equal(np.asarray(occ), want)


def test_implicit_closest_matches_oracle():
    mesh = random_soup(500, seed=5)
    wide = build_wide_implicit(mesh.vertices, mesh.indices, leaf_size=6)
    o, d = _rays_for(mesh, n=256, seed=9)
    t_k, id_k = trace_closest_wide(wide, o, d)
    t_ref, _ = brute_force_closest(mesh, np.asarray(o), np.asarray(d))
    hit = np.isfinite(t_ref)
    assert (np.asarray(id_k >= 0) == hit).all()
    np.testing.assert_allclose(np.asarray(t_k)[hit], t_ref[hit],
                               rtol=2e-4, atol=1e-4)


def test_corners_path_matches_gather_path():
    mesh = random_soup(300, seed=2)
    a = build_wide_implicit(mesh.vertices, mesh.indices, leaf_size=8)
    c0, c1, c2 = expand_corners(mesh.vertices, mesh.indices)
    b = build_wide_implicit_corners(c0, c1, c2, leaf_size=8)
    np.testing.assert_array_equal(np.asarray(a.nodes), np.asarray(b.nodes))
    np.testing.assert_array_equal(np.asarray(a.tris), np.asarray(b.tris))
    np.testing.assert_array_equal(np.asarray(a.tri_id),
                                  np.asarray(b.tri_id))


@pytest.mark.slow  # round-5 re-tier: the implicit 8-ary tree is the
# non-default rebuild tier (clip refit is production config 4)
def test_implicit_refit_is_correct_on_deformed_geometry():
    """Frozen topology + re-boxed leaves must stay exact for occlusion on
    the DEFORMED geometry (boxes conservative by construction)."""
    import dataclasses
    mesh = random_soup(400, seed=7)
    wide, tri_sorted = build_wide_implicit(mesh.vertices, mesh.indices,
                                           leaf_size=8,
                                           with_sorted_ids=True)
    v2 = deform(mesh, time=0.8)
    refit = refit_wide_implicit(jnp.asarray(v2), tri_sorted, wide.tri_id,
                                wide.leaf_size)
    assert refit.nodes.shape == wide.nodes.shape
    mesh2 = dataclasses.replace(mesh, vertices=v2)
    o, d = _rays_for(mesh2, n=384, seed=13)
    occ = trace_any_wide(refit, o, d, jnp.full(o.shape[0], 3.4e38))
    want = brute_force_any(mesh2, np.asarray(o), np.asarray(d))
    np.testing.assert_array_equal(np.asarray(occ), want)


def test_refit_corners_matches_refit_gather():
    mesh = random_soup(256, seed=1)
    wide, tri_sorted = build_wide_implicit(mesh.vertices, mesh.indices,
                                           leaf_size=8,
                                           with_sorted_ids=True)
    v2 = jnp.asarray(deform(mesh, time=0.3))
    a = refit_wide_implicit(v2, tri_sorted, wide.tri_id, wide.leaf_size)
    sv0 = v2[tri_sorted[:, 0]]
    se1 = v2[tri_sorted[:, 1]] - sv0
    se2 = v2[tri_sorted[:, 2]] - sv0
    b = refit_wide_implicit_corners(sv0, se1, se2, wide.tri_id,
                                    wide.leaf_size)
    np.testing.assert_allclose(np.asarray(a.nodes), np.asarray(b.nodes),
                               rtol=1e-6, atol=1e-6)


def test_tri_ids_stay_in_range():
    mesh = random_soup(123, seed=4)
    wide = build_wide_implicit(mesh.vertices, mesh.indices, leaf_size=14)
    ids = np.asarray(wide.tri_id)
    assert ids.min() >= 0 and ids.max() < 123
