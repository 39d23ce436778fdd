"""The 8-wide XLA walk (bvh/traverse.traverse_wide) against the NumPy
brute-force oracle (bvh/reference.py), over every kind of tree the renderer
builds. The walk is the CUDA kernel's plain twin — the reference it is
checked against on the card — so its semantics are pinned here: t_max,
inactive rays, axis-parallel rays, empty slots, clustered leaves, SBVH and
refit trees, and counted (never silent) walk errors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh import traverse as walk
from tpurt.bvh.lbvh import build_lbvh
from tpurt.bvh.reference import brute_force_closest
from tpurt.bvh.wide import STACK_SIZES, build_wide, count_wide, \
    round_up_bucket, stack_size_for, wide_levels_device, widen_lbvh
from tpurt.scenes import deform, random_soup


def _rays(seed, n=384, extent=9.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _check_against_oracle(mesh, wide, o, d, t_max=np.inf):
    """Closest t + hit set and any-hit occlusion vs brute force."""
    tm = np.broadcast_to(np.asarray(t_max, np.float32), o.shape[:1])
    want_t, want_id = brute_force_closest(mesh, o, d, t_max=np.where(
        tm > 0, tm, 0.0))
    t, sidx, err = walk.traverse_wide(wide, jnp.asarray(o), jnp.asarray(d),
                                      t_max=jnp.asarray(tm))
    assert int(err) == 0
    hit = np.isfinite(want_t)
    np.testing.assert_array_equal(np.asarray(sidx) >= 0, hit)
    np.testing.assert_allclose(np.asarray(t)[hit], want_t[hit], rtol=3e-4,
                               atol=1e-5)
    # The sorted index names the oracle's triangle (ties aside).
    tri = np.asarray(wide.tri_id)[np.asarray(sidx)[hit]]
    assert (tri == want_id[hit]).mean() > 0.99
    _, sany, err = walk.traverse_wide(wide, jnp.asarray(o), jnp.asarray(d),
                                      t_max=jnp.asarray(tm), any_hit=True)
    assert int(err) == 0
    np.testing.assert_array_equal(np.asarray(sany) >= 0, hit)


def _morton(mesh, leaf=4, **kw):
    return build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                      leaf_size=leaf, **kw)


def case_closest_and_any():
    mesh = random_soup(220, seed=1)
    o, d = _rays(1)
    _check_against_oracle(mesh, build_wide(_morton(mesh)), o, d)


def case_per_ray_t_max():
    mesh = random_soup(220, seed=2)
    o, d = _rays(2)
    tmax = np.random.default_rng(2).uniform(0.5, 14.0, len(o))
    _check_against_oracle(mesh, build_wide(_morton(mesh)), o, d, tmax)


def case_inactive_rays():
    mesh = random_soup(120, seed=3)
    o, d = _rays(3, n=256)
    tmax = np.where(np.arange(256) % 2 == 0, 0.0, -1.0)
    t, sidx, err = walk.traverse_wide(build_wide(_morton(mesh)),
                                      jnp.asarray(o), jnp.asarray(d),
                                      t_max=jnp.asarray(tmax, jnp.float32))
    assert int(err) == 0
    assert (np.asarray(sidx) == -1).all() and np.isinf(np.asarray(t)).all()


def case_axis_parallel_rays():
    """inv_dir = +-inf components: the clamped inverse keeps the slab test
    NaN-free, including origins lying exactly on slab planes."""
    mesh = random_soup(200, seed=4)
    rng = np.random.default_rng(4)
    n = 384
    o = rng.uniform(-9, 9, (n, 3)).astype(np.float32)
    o[: n // 3] = np.round(o[: n // 3])          # on integer planes
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    _check_against_oracle(mesh, build_wide(_morton(mesh)), o, d)


def case_empty_slots():
    """A tree too small to fill its rows: empty slots (inverted boxes, ref
    -1 = leaf 0) must never be hit."""
    mesh = random_soup(10, seed=5)
    wide = build_wide(_morton(mesh, leaf=1))
    rows = np.asarray(wide.nodes).reshape(-1, 8, 16)[:wide.num_wide]
    assert (rows[:, :, 0] > rows[:, :, 3]).any(), "no empty slot to test"
    o, d = _rays(5)
    _check_against_oracle(mesh, wide, o, d)


def case_clustered_leaves():
    """Sub-leaf clustered tree (tree-leaves share triangle blocks)."""
    mesh = random_soup(300, seed=6)
    bvh = _morton(mesh, leaf=4, split_blocks=12)
    assert bvh.leaf_block is not None
    o, d = _rays(6)
    _check_against_oracle(mesh, build_wide(bvh), o, d)


def case_fixed_and_area_collapse():
    mesh = random_soup(260, seed=7)
    bvh = _morton(mesh, leaf=2)
    o, d = _rays(7)
    for mode in ("fixed", "area"):
        nw = round_up_bucket(max(count_wide(bvh, mode=mode), 1), 64)
        _check_against_oracle(mesh, widen_lbvh(bvh, nw_pad=nw, mode=mode),
                              o, d)


def case_sbvh():
    """Native SBVH (duplicated triangle references, clipped leaf boxes)."""
    from tpurt.bvh.sah import build_sah_lbvh
    mesh = random_soup(260, seed=8)
    bvh = build_sah_lbvh(mesh, leaf_size=14)
    o, d = _rays(8)
    _check_against_oracle(mesh, build_wide(bvh, from_node_boxes=True), o, d)


def case_clip_refit():
    """Clip-geometry refit of an SBVH after deformation."""
    from tpurt.bvh.clip_refit import make_clip_refit, refit_sbvh_wide
    from tpurt.bvh.sah import build_sah_lbvh
    mesh = random_soup(200, seed=9)
    bvh = build_sah_lbvh(mesh, leaf_size=8)
    plan = make_clip_refit(bvh, round_up_bucket(count_wide(bvh), 64))
    v2 = deform(mesh, time=0.6, amplitude=0.3)
    wide, _ = refit_sbvh_wide(plan, bvh, None, None, None,
                              vertices=jnp.asarray(v2))
    o, d = _rays(9)
    _check_against_oracle(dataclasses.replace(mesh, vertices=v2), wide, o, d)


CASES = {f.__name__[5:]: f for f in (
    case_closest_and_any, case_per_ray_t_max, case_inactive_rays,
    case_axis_parallel_rays, case_empty_slots, case_clustered_leaves,
    case_fixed_and_area_collapse, case_sbvh, case_clip_refit)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_walk_matches_oracle(case):
    CASES[case]()


@pytest.mark.parametrize("limit", ["stack", "iterations"])
def test_walk_errors_are_counted(limit, monkeypatch):
    """A walk that overflows its stack or passes its iteration cap is
    counted, not returned as a silent miss."""
    if limit == "iterations":
        monkeypatch.setattr(walk, "wide_iteration_cap", lambda nw: 2)
    mesh = random_soup(300, seed=10)
    wide = build_wide(_morton(mesh, leaf=1))
    if limit == "stack":
        wide = dataclasses.replace(wide, stack_depth=2)
    o, d = _rays(10, n=128)
    one = jax.vmap(lambda o, d, tm: walk._wide_walk_one(wide, False, 0.0,
                                                        o, d, tm))
    _, _, err = one(jnp.asarray(o), jnp.asarray(d),
                    jnp.full((128,), jnp.inf, jnp.float32))
    assert np.asarray(err).sum() > 0


def _levels_bfs(wide) -> int:
    """Wide levels by a plain breadth-first walk from the root row (a child
    ref > 0 is a node row; leaves and empty slots are negative)."""
    rows = np.asarray(wide.nodes).reshape(-1, 8, 16)
    level, frontier = 0, [0]
    while frontier:
        level += 1
        frontier = [int(r) for n in frontier for r in rows[n, :, 6] if r > 0]
    return level


LEVEL_TREES = {
    "morton_leaf1": lambda m: build_wide(_morton(m, leaf=1)),
    "morton_fixed": lambda m: build_wide(_morton(m, leaf=2), mode="fixed"),
    "clustered": lambda m: build_wide(_morton(m, leaf=4, split_blocks=12)),
    "one_row": lambda m: build_wide(_morton(m, leaf=8)),
}


@pytest.mark.parametrize("tree", sorted(LEVEL_TREES))
def test_wide_levels_match_bfs(tree):
    """The device depth count (pointer doubling) agrees with a BFS, and the
    stack the build chose holds 7 * levels + 1 entries."""
    mesh = random_soup(300 if tree != "one_row" else 40, seed=11)
    wide = LEVEL_TREES[tree](mesh)
    levels = int(wide_levels_device(wide.nodes))
    assert levels == _levels_bfs(wide)
    assert wide.stack_depth == stack_size_for(levels)
    assert 7 * levels + 1 <= wide.stack_depth


def test_stack_size_choice_and_refusal():
    assert [stack_size_for(n) for n in (1, 9, 10, 18, 19, 36)] == [
        64, 64, 128, 128, 256, 256]
    assert STACK_SIZES[-1] == 256
    with pytest.raises(ValueError, match="levels"):
        stack_size_for(37)


def _chain_tree(levels: int):
    """A hand-made WideBVH: a chain of ``levels`` rows whose slot 7 is the
    next row and slots 0-6 are (empty-triangle) leaves, every box the same.
    The walk pops slot 7 first, so 7 leaves wait per level: the stack peaks
    at 7 * (levels - 1) + 8 entries."""
    from tpurt.bvh.wide import WideBVH
    rows = np.zeros((levels, 8, 16), np.float32)
    rows[:, :, 0:3] = -1.0
    rows[:, :, 3:6] = 1.0
    leaf = np.arange(levels * 8, dtype=np.float32).reshape(levels, 8)
    rows[:, :, 6] = -(leaf + 1.0)
    rows[:-1, 7, 6] = np.arange(1, levels, dtype=np.float32)
    n_leaves = levels * 8
    return WideBVH(nodes=jnp.asarray(rows.reshape(levels, 128)),
                   tris=jnp.zeros((n_leaves, 128), jnp.float32),
                   tri_id=jnp.arange(n_leaves, dtype=jnp.int32),
                   root_min=jnp.full((3,), -1.0), root_max=jnp.ones((3,)),
                   num_wide=levels, leaf_size=1)


def test_deep_tree_walks_without_overflow():
    """A tree too deep for the smallest stack: size_stack picks a larger
    one and the walk counts no error, where the smallest overflows."""
    from tpurt.bvh.wide import size_stack
    chain = _chain_tree(12)
    assert int(wide_levels_device(chain.nodes)) == 12
    sized = size_stack(chain)
    assert sized.stack_depth == 128
    o = jnp.zeros((32, 3))
    d = jnp.tile(jnp.asarray([[0.3, 0.5, 0.81]]), (32, 1))
    for wide, want_err in ((sized, 0), (chain, 32)):
        for any_hit in (False, True):
            _, sidx, err = walk.traverse_wide(wide, o, d, any_hit=any_hit)
            assert int(err) == want_err
            assert (np.asarray(sidx) == -1).all()
