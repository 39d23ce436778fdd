"""Sub-leaf clustered rebuild (bvh/lbvh._subleaf_split, round 5).

The config-2 rebuilt-tree quality pass: the top-M triangle blocks are
split at their largest internal Morton jump into two tight-boxed
tree-leaves that share the block's triangle rows (no re-gather; see the
LBVH docstring). These tests pin the structural invariants and the
traversal parity against the unclustered build — same hits, same
shadows, only the visit counts change.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh.lbvh import auto_split_blocks, build_lbvh
from tpurt.bvh.traverse import traverse
from tpurt.camera import generate_rays
from tpurt.scenes import default_camera_for, teapot_scene

M = 60
LEAF = 8


@pytest.fixture(scope="module")
def scene():
    mesh = teapot_scene(1500)
    v = jnp.asarray(mesh.vertices)
    i = jnp.asarray(mesh.indices)
    plain = build_lbvh(v, i, leaf_size=LEAF)
    clustered = build_lbvh(v, i, leaf_size=LEAF, split_blocks=M)
    return mesh, plain, clustered


def test_structure(scene):
    _, plain, cl = scene
    nb = plain.num_leaves                       # plain: leaves == blocks
    assert cl.num_blocks == nb
    assert cl.num_leaves == nb + M
    blk = np.asarray(cl.leaf_block)
    assert blk.shape == (nb + M,)
    # Morton order preserved: block ids non-decreasing, every block
    # referenced once or twice, all in range.
    assert (np.diff(blk) >= 0).all()
    counts = np.bincount(blk, minlength=nb)
    assert counts.min() >= 1 and counts.max() <= 2
    assert (counts == 2).sum() == M
    # Triangle arrays untouched (no re-gather).
    np.testing.assert_array_equal(np.asarray(plain.tri_id),
                                  np.asarray(cl.tri_id))
    np.testing.assert_array_equal(np.asarray(plain.tri_v0),
                                  np.asarray(cl.tri_v0))


def test_subleaf_boxes(scene):
    """Each block's sub-leaf boxes union to the block's full-triangle box
    and are pairwise tighter (that tightness IS the quality win)."""
    _, plain, cl = scene
    k = cl.leaf_size
    v0, e1, e2 = (np.asarray(cl.tri_v0), np.asarray(cl.tri_e1),
                  np.asarray(cl.tri_e2))
    v1, v2 = v0 + e1, v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    nb = cl.num_blocks
    bmin = tmin.reshape(nb, k, 3).min(1)
    bmax = tmax.reshape(nb, k, 3).max(1)
    blk = np.asarray(cl.leaf_block)
    lmin = np.asarray(cl.leaf_min)
    lmax = np.asarray(cl.leaf_max)
    # containment: every sub-leaf box inside its block box
    assert (lmin >= bmin[blk] - 1e-6).all()
    assert (lmax <= bmax[blk] + 1e-6).all()
    # coverage: per-block union of sub-leaf boxes equals the block box
    umin = np.full((nb, 3), np.inf)
    umax = np.full((nb, 3), -np.inf)
    np.minimum.at(umin, blk, lmin)
    np.maximum.at(umax, blk, lmax)
    np.testing.assert_allclose(umin, bmin, atol=1e-6)
    np.testing.assert_allclose(umax, bmax, atol=1e-6)


def test_traversal_parity(scene):
    mesh, plain, cl = scene
    cam = default_camera_for(mesh)
    o, d = generate_rays(cam, 48, 48)
    t0, id0 = traverse(plain, o, d)
    t1, id1 = traverse(cl, o, d)
    hit0 = np.asarray(id0) >= 0
    hit1 = np.asarray(id1) >= 0
    np.testing.assert_array_equal(hit0, hit1)
    np.testing.assert_allclose(np.asarray(t0)[hit0], np.asarray(t1)[hit1],
                               rtol=1e-5, atol=1e-5)
    # any-hit agreement
    ta0, _ = traverse(plain, o, d, any_hit=True)
    ta1, _ = traverse(cl, o, d, any_hit=True)
    np.testing.assert_array_equal(np.asarray(ta0) < np.inf,
                                  np.asarray(ta1) < np.inf)


def test_refit_guard(scene):
    from tpurt.bvh.lbvh import refit_lbvh
    mesh, _, cl = scene
    with pytest.raises(AssertionError):
        refit_lbvh(cl, jnp.asarray(mesh.vertices),
                   jnp.asarray(mesh.indices))


def test_auto_split_blocks():
    # Sponza-class: capped by the ~30k SMEM topology gate.
    nb = 260_008 // 14 + 1                     # ~Tpad // 14
    m = auto_split_blocks(260_000, 14)
    assert 0 < m <= nb // 2
    assert nb + m <= 30_000
    # tiny scenes: half the blocks
    assert auto_split_blocks(1500, 8) > 0


def test_cache_roundtrip(tmp_path, scene):
    from tpurt.checkpoint import load_bvh, save_bvh
    _, _, cl = scene
    save_bvh(str(tmp_path), "clu", cl)
    back = load_bvh(str(tmp_path), "clu")
    assert back.leaf_block is not None
    np.testing.assert_array_equal(np.asarray(back.leaf_block),
                                  np.asarray(cl.leaf_block))
    np.testing.assert_allclose(np.asarray(back.leaf_min),
                               np.asarray(cl.leaf_min))


@pytest.mark.slow
def test_wide_parity(scene):
    """Clustered tree through the production wide collapse + the XLA
    wide walk: same hits as the binary walk."""
    from tpurt.bvh.traverse import traverse_wide
    from tpurt.bvh.wide import build_wide
    mesh, _, cl = scene
    w = build_wide(cl)
    cam = default_camera_for(mesh)
    o, d = generate_rays(cam, 32, 32)
    tb, _ = traverse(cl, o, d)
    tw, _, _ = traverse_wide(w, o, d)
    np.testing.assert_allclose(np.nan_to_num(np.asarray(tb), posinf=0.0),
                               np.nan_to_num(np.asarray(tw), posinf=0.0),
                               rtol=1e-4, atol=1e-4)
    occ_b, _ = traverse(cl, o, d, any_hit=True)
    _, occ_w, _ = traverse_wide(w, o, d, t_max=jnp.full(o.shape[:-1],
                                                         3.0e38),
                                any_hit=True)
    np.testing.assert_array_equal(np.asarray(occ_b) < np.inf,
                                  np.asarray(occ_w) >= 0)


@pytest.mark.slow
def test_rebuild_fused_clustered(scene):
    """The fused rebuild program (deferred boxes + fixed collapse) with
    split_blocks produces an accel tracing identically to the full-box
    clustered build."""
    from tpurt.bvh.traverse import traverse_wide
    from tpurt.bvh.wide import count_wide, round_up_bucket, widen_lbvh
    mesh, _, cl = scene
    v = jnp.asarray(mesh.vertices)
    i = jnp.asarray(mesh.indices)
    b2 = build_lbvh(v, i, leaf_size=LEAF, split_blocks=M, boxes="defer")
    nw = round_up_bucket(max(count_wide(cl, mode="fixed"), 1))
    w2 = widen_lbvh(b2, nw_pad=nw, mode="fixed")
    cam = default_camera_for(mesh)
    o, d = generate_rays(cam, 32, 32)
    tb, _ = traverse(cl, o, d)
    tw, _, _ = traverse_wide(w2, o, d)
    np.testing.assert_allclose(np.nan_to_num(np.asarray(tb), posinf=0.0),
                               np.nan_to_num(np.asarray(tw), posinf=0.0),
                               rtol=1e-4, atol=1e-4)
