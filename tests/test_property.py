"""Property-based tests (SURVEY.md §4.3): random meshes + random rays must
agree between brute force, the CPU oracle BVH, the binary JAX traversal
and the 8-wide XLA walk; refits after perturbation must stay conservative."""

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from tpurt.bvh.lbvh import build_lbvh, refit_lbvh
from tpurt.bvh.reference import brute_force_closest
from tpurt.bvh.traverse import traverse, traverse_wide
from tpurt.bvh.wide import build_wide
from tpurt.scenes import random_soup

pytestmark = pytest.mark.slow  # compile-heavy: full-suite tier only


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    """Property tests compile dozens of unique tiny programs that a cache
    can never amortize — and a full-suite crash was once traced to the
    persistent cache's executable write during this module's compile
    storm — so the module runs with the persistent cache off."""
    import jax
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


@st.composite
def scene_and_rays(draw):
    # nt is drawn from fixed buckets, not a continuous range: every
    # distinct triangle count is a distinct XLA program, and the compile
    # storm (not the checking) is what made this module take 4+ minutes
    # per test. Seeds (content) stay fully random.
    nt = draw(st.sampled_from([9, 16, 33, 64, 120]))
    mesh_seed = draw(st.integers(min_value=0, max_value=2**31 - 1))
    ray_seed = draw(st.integers(min_value=0, max_value=2**31 - 1))
    leaf = draw(st.sampled_from([1, 2, 4, 7]))
    return nt, mesh_seed, ray_seed, leaf


@settings(max_examples=12, deadline=None)
@given(scene_and_rays())
def test_all_paths_agree_on_random_scenes(params):
    nt, mesh_seed, ray_seed, leaf = params
    mesh = random_soup(nt, seed=mesh_seed)
    rng = np.random.default_rng(ray_seed)
    o = rng.uniform(-9, 9, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)

    want_t, _ = brute_force_closest(mesh, o, d)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                     leaf_size=leaf)
    jt, _ = traverse(bvh, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(jt), want_t, rtol=3e-4, atol=1e-6)

    wide = build_wide(bvh, bucket=64)
    kt, _, errors = traverse_wide(wide, jnp.asarray(o), jnp.asarray(d))
    assert int(errors) == 0
    np.testing.assert_allclose(np.asarray(kt), want_t, rtol=3e-4, atol=1e-6)


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=0.01, max_value=2.0))
def test_refit_stays_conservative_under_perturbation(seed, amplitude):
    mesh = random_soup(60, seed=seed % 1000)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                     leaf_size=4)
    rng = np.random.default_rng(seed)
    moved = (np.asarray(mesh.vertices)
             + rng.normal(0, amplitude,
                          mesh.vertices.shape).astype(np.float32))
    refit = refit_lbvh(bvh, jnp.asarray(moved), None)
    # Every child box must contain its subtree's triangles exactly: validate
    # via traversal-vs-brute-force agreement on the deformed geometry.
    import dataclasses
    mesh2 = dataclasses.replace(mesh, vertices=moved)
    o = rng.uniform(-9, 9, (32, 3)).astype(np.float32)
    d = rng.normal(size=(32, 3)).astype(np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    want_t, _ = brute_force_closest(mesh2, o, d)
    got_t, _ = traverse(refit, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(got_t), want_t, rtol=3e-4,
                               atol=1e-6)
