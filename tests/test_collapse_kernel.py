"""8-wide collapses: the area-greedy frontier (wide.frontiers_area +
reachability) static and refit scenes take, and the fixed cut of the fused
per-frame rebuild (app._rebuild_fused). Traces through them must match the
binary walk and brute force, and their rows must form a valid tree."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh.lbvh import build_lbvh
from tpurt.bvh.traverse import traverse, traverse_wide
from tpurt.bvh.wide import count_wide, round_up_bucket, widen_lbvh
from tpurt.scenes import random_soup


def _rays(rng, n, extent=8.0):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize(
    "nt,leaf,seed",
    [pytest.param(250, 2, 5, marks=pytest.mark.slow),
     pytest.param(500, 4, 0, marks=pytest.mark.slow),
     pytest.param(800, 8, 3, marks=pytest.mark.slow)])
def test_kernel_collapse_matches_xla_area_widen(nt, leaf, seed):
    """The area collapse traces exactly like the binary tree it came from
    (closest t and ids, and occlusion)."""
    mesh = random_soup(nt, seed=seed)
    full = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                      leaf_size=leaf)
    nw_pad = round_up_bucket(max(count_wide(full, mode="area"), 1), 64)
    acc = widen_lbvh(full, nw_pad=nw_pad, mode="area")
    o, d = _rays(np.random.default_rng(seed), 320)
    t0, i0 = traverse(full, o, d)
    t1, s1, err = traverse_wide(acc, o, d)
    assert int(err) == 0
    i1 = jnp.where(s1 >= 0, acc.tri_id[jnp.maximum(s1, 0)], -1)
    np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    tm = jnp.full((320,), 25.0, jnp.float32)
    _, h0 = traverse(full, o, d, t_max=tm, any_hit=True)
    _, h1, _ = traverse_wide(acc, o, d, t_max=tm, any_hit=True)
    np.testing.assert_array_equal(np.asarray(h0) >= 0, np.asarray(h1) >= 0)


def test_rebuild_fused_traces_correctly():
    """Config-2 plumbing: _rebuild_fused — the full per-frame program
    (clustered build + fixed-cut collapse + shade table) — yields an accel
    whose closest hits agree with brute force, carrying the stack size it
    is given and reporting its own count and depth."""
    from tpurt.app import _rebuild_fused
    from tpurt.bvh.reference import brute_force_closest
    from tpurt.bvh.wide import wide_levels_device

    mesh = random_soup(250, seed=13)
    v = jnp.asarray(mesh.vertices)
    i = jnp.asarray(mesh.indices)
    msp = 8
    b0 = build_lbvh(v, i, leaf_size=4, split_blocks=msp)
    nw = round_up_bucket(max(count_wide(b0, mode="fixed"), 1), 64)
    _, wide, st, cnt, levels = _rebuild_fused(v, i, mesh, 4, nw,
                                              stack_depth=128,
                                              split_blocks=msp)
    assert int(cnt) <= nw
    assert wide.stack_depth == 128
    assert int(levels) == int(wide_levels_device(wide.nodes)) >= 2
    assert st.shape[0] == wide.tri_id.shape[0]
    rng = np.random.default_rng(2)
    o = rng.uniform(-9, 9, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wt, _ = brute_force_closest(mesh, o, d)
    jt, _, err = traverse_wide(wide, jnp.asarray(o), jnp.asarray(d))
    assert int(err) == 0
    np.testing.assert_allclose(np.asarray(jt), wt, rtol=3e-4, atol=1e-6)


@pytest.mark.slow
def test_kernel_collapse_structure():
    """Structural invariants: root is wide id 0; every wide row's children
    are dense ids < count or leaves; leaf coverage is a partition."""
    mesh = random_soup(250, seed=9)
    full = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                      leaf_size=4)
    count = count_wide(full, mode="area")
    acc = widen_lbvh(full, nw_pad=round_up_bucket(max(count, 1), 64),
                     mode="area")
    rows = np.asarray(acc.nodes).reshape(-1, 8, 16)
    refs = rows[:, :, 6].astype(np.int64)
    empty = rows[:, :, 0] > rows[:, :, 3]
    nl = full.num_leaves
    seen = np.zeros(nl, bool)
    for w in range(count):
        for s in range(8):
            if empty[w, s]:
                continue
            r = int(refs[w, s])
            if r >= 0:
                assert 0 < r < count          # dense id, not self/root
            else:
                leaf = -r - 1
                assert 0 <= leaf < nl
                assert not seen[leaf], "leaf referenced twice"
                seen[leaf] = True
    assert seen.all(), "every leaf reachable exactly once"
