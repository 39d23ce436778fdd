"""Clip-geometry SBVH refit (tpurt/bvh/clip_refit.py): barycentric clip
polygons, conservative covering under deformation, and wide assembly.

The core property: spatial-split leaf boxes are (triangle ∩ leaf box); a
refit evaluates those polygons at the DEFORMED corners, so the refit tree
must stay exact for occlusion on the deformed geometry while keeping
boxes no looser than the full-triangle union. CPU, XLA wide walk."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh.clip_refit import (ClipRefitPlan, clip_slots_bary,
                                  make_clip_refit, refit_sbvh,
                                  refit_sbvh_wide)
from tpurt.bvh.reference import brute_force_any
from tpurt.bvh.sah import build_sah_lbvh
from tpurt.bvh.wide import build_wide, count_wide, round_up_bucket
from tpurt.bvh.traverse import traverse_wide
from tpurt.scenes import deform, random_soup, teapot_scene


def trace_any_wide(wide, o, d, t_max):
    """Occlusion from the XLA wide walk (the CUDA kernel's plain twin)."""
    _, sidx, errors = traverse_wide(wide, o, d, t_max=t_max, any_hit=True)
    assert int(errors) == 0
    return sidx >= 0



@pytest.fixture(scope="module")
def sbvh_scene():
    mesh = teapot_scene(2_500)
    sah = build_sah_lbvh(mesh, leaf_size=8)
    if sah is None:
        pytest.skip("native SAH library unavailable")
    nw_pad = round_up_bucket(max(count_wide(sah), 1), 256)
    plan = make_clip_refit(sah, nw_pad, device=False)   # host f64 oracle
    return mesh, sah, plan


def _rays_for(mesh, n=512, seed=3):
    rng = np.random.default_rng(seed)
    v = np.asarray(mesh.vertices)
    lo, hi = v.min(0), v.max(0)
    span = hi - lo
    o = rng.uniform(lo - 0.3 * span, hi + 0.3 * span, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32))


def test_plan_is_a_pytree(sbvh_scene):
    _, _, plan = sbvh_scene
    moved = jax.device_put(plan)          # would raise on a non-pytree
    assert isinstance(moved, ClipRefitPlan)
    leaves = jax.tree_util.tree_leaves(plan)
    assert len(leaves) >= 2


def test_clip_polygons_lie_in_triangle_and_leaf_box(sbvh_scene):
    _, sah, plan = sbvh_scene
    bary = np.asarray(plan.bary)          # [S, P, 2]
    b1, b2 = bary[..., 0], bary[..., 1]
    assert (b1 >= -1e-5).all() and (b2 >= -1e-5).all()
    assert (b1 + b2 <= 1 + 1e-5).all()


def test_refit_identity_never_loosens_stored_boxes(sbvh_scene):
    """At the build pose the polygon AABBs must stay INSIDE the native
    builder's stored clipped leaf boxes (the builder's chopped-binning
    clip may be slightly conservative; the exact polygon never is)."""
    from tpurt.bvh.clip_refit import _leaf_boxes_np
    _, sah, plan = sbvh_scene
    _, (lmin, lmax) = refit_sbvh(sah, plan.bary, sah.tri_v0, sah.tri_e1,
                                 sah.tri_e2)
    smin, smax = _leaf_boxes_np(sah)
    ext = float(np.max(smax - smin))
    assert (np.asarray(lmin) >= smin - 2e-4 * ext).all()
    assert (np.asarray(lmax) <= smax + 2e-4 * ext).all()


@pytest.mark.slow
def test_refit_identity_occlusion_matches_static(sbvh_scene):
    mesh, sah, plan = sbvh_scene
    static = build_wide(sah, from_node_boxes=True)
    wide, _ = refit_sbvh_wide(plan, sah, sah.tri_v0, sah.tri_e1,
                              sah.tri_e2)
    o, d = _rays_for(mesh)
    tm = jnp.full(o.shape[0], 3.4e38)
    occ_s = trace_any_wide(static, o, d, tm)
    occ_r = trace_any_wide(wide, o, d, tm)
    np.testing.assert_array_equal(np.asarray(occ_s), np.asarray(occ_r))


def test_refit_deformed_is_exact_for_occlusion(sbvh_scene):
    """Deform via the vertices path; the refit SBVH must agree with brute
    force on the deformed mesh — the conservative-covering property."""
    mesh, sah, plan = sbvh_scene
    v2 = deform(mesh, time=0.9, amplitude=0.25)
    wide, _ = refit_sbvh_wide(plan, sah, None, None, None,
                              vertices=jnp.asarray(v2))
    mesh2 = dataclasses.replace(mesh, vertices=v2)
    o, d = _rays_for(mesh2, n=512, seed=17)
    occ = trace_any_wide(wide, o, d, jnp.full(o.shape[0], 3.4e38))
    want = brute_force_any(mesh2, np.asarray(o), np.asarray(d))
    np.testing.assert_array_equal(np.asarray(occ), want)


def test_deformed_boxes_stay_tighter_than_full_triangle(sbvh_scene):
    """The point of clip refit: summed leaf-box area after deformation
    must undercut the full-triangle refit's (else the spatial-split
    advantage is gone and the module is pointless)."""
    from tpurt.bvh.lbvh import refit_lbvh
    from tpurt.bvh.wide import _leaf_boxes_from_tris
    mesh, sah, plan = sbvh_scene
    v2 = jnp.asarray(deform(mesh, time=0.6, amplitude=0.2))
    tri = sah.tri_sorted
    sv0 = v2[tri[:, 0]]
    se1 = v2[tri[:, 1]] - sv0
    se2 = v2[tri[:, 2]] - sv0
    _, (cmin, cmax) = refit_sbvh(sah, plan.bary, sv0, se1, se2)
    full = refit_lbvh(sah, v2, None)
    fmin, fmax = _leaf_boxes_from_tris(full)

    def area(mn, mx):
        e = np.maximum(np.asarray(mx) - np.asarray(mn), 0.0)
        return float(np.sum(e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                            + e[:, 0] * e[:, 2]))

    a_clip = area(cmin, cmax)
    a_full = area(fmin, fmax)
    assert a_clip <= a_full * 1.0001
    # Clipped boxes must also be contained in the full-triangle boxes
    # (modulo the refit's conservative 1e-4-of-extent pad).
    ext = float(np.max(np.asarray(fmax) - np.asarray(fmin)))
    assert (np.asarray(cmin) >= np.asarray(fmin) - 2e-4 * ext).all()
    assert (np.asarray(cmax) <= np.asarray(fmax) + 2e-4 * ext).all()


def test_device_precompute_matches_host_oracle(sbvh_scene):
    """The f32 device polygon extraction must produce refit boxes that
    (a) cover the host-f64 oracle's boxes minus a small epsilon — the
    conservative direction traversal correctness depends on — and (b)
    stay within the full-triangle boxes (still clipped, not inflated)."""
    from tpurt.bvh.clip_refit import (clip_slots_bary_device,
                                      slot_boxes_from_nodes)
    from tpurt.bvh.wide import _leaf_boxes_from_tris
    _, sah, plan = sbvh_scene
    bmin, bmax = slot_boxes_from_nodes(sah)
    bary_d, slack_d = jax.jit(clip_slots_bary_device)(
        sah.tri_v0, sah.tri_e1, sah.tri_e2, bmin, bmax)
    _, (dmin, dmax) = refit_sbvh(sah, bary_d, sah.tri_v0, sah.tri_e1,
                                 sah.tri_e2, slack=slack_d)
    _, (hmin, hmax) = refit_sbvh(sah, plan.bary, sah.tri_v0, sah.tri_e1,
                                 sah.tri_e2)
    dmin, dmax = np.asarray(dmin), np.asarray(dmax)
    hmin, hmax = np.asarray(hmin), np.asarray(hmax)
    ext = float(np.max(hmax - hmin))
    # (a) device boxes cover the oracle boxes (conservative side)
    assert (dmin <= hmin + 1e-3 * ext).all()
    assert (dmax >= hmax - 1e-3 * ext).all()
    # (b) device boxes are still meaningfully clipped
    fmin, fmax = _leaf_boxes_from_tris(sah)
    assert (dmin >= np.asarray(fmin) - 1e-3 * ext).all()
    assert (dmax <= np.asarray(fmax) + 1e-3 * ext).all()


def test_device_precompute_occlusion_exact(sbvh_scene):
    """End-to-end: a refit from the DEVICE-precomputed plan must agree
    with brute force on a deformed mesh (same exactness property the
    host plan satisfies)."""
    from tpurt.bvh.clip_refit import make_clip_refit
    mesh, sah, _ = sbvh_scene
    nw_pad = round_up_bucket(max(count_wide(sah), 1), 256)
    plan_d = make_clip_refit(sah, nw_pad, device=True)
    v2 = deform(mesh, time=0.7, amplitude=0.22)
    wide, _ = refit_sbvh_wide(plan_d, sah, None, None, None,
                              vertices=jnp.asarray(v2))
    mesh2 = dataclasses.replace(mesh, vertices=v2)
    o, d = _rays_for(mesh2, n=512, seed=23)
    occ = trace_any_wide(wide, o, d, jnp.full(o.shape[0], 3.4e38))
    want = brute_force_any(mesh2, np.asarray(o), np.asarray(d))
    np.testing.assert_array_equal(np.asarray(occ), want)


def test_refit_sbvh_wide_is_jittable(sbvh_scene):
    mesh, sah, plan = sbvh_scene
    f = jax.jit(lambda b, v: refit_sbvh_wide(plan, b, None, None, None,
                                             vertices=v)[0])
    wide = f(sah, jnp.asarray(deform(mesh, 0.2)))
    assert np.isfinite(np.asarray(wide.nodes)).all()


def test_dedup_merge_slack_keeps_box_conservative():
    """Two distinct hull vertices closer than the dedup ball (2e-4 bary)
    merge in the device precompute; the recorded per-slot slack, scaled
    by the edge lengths at refit time, must re-cover the merged vertex —
    the quantized-key version of this dedup could drop a vertex with only
    a slot-extent pad, shrinking the box below the true clip polygon."""
    from tpurt.bvh.clip_refit import clip_slots_bary_device

    delta = 1e-5
    sv0 = jnp.array([[0.0, 0.0, 0.0]])
    se1 = jnp.array([[1.0, 0.0, 0.0]])
    se2 = jnp.array([[0.0, 1.0, 0.0]])
    # Box clips at x<=0.5 and y<=0.5+delta: the hypotenuse crossings
    # (0.5, 0.5) and (0.5-delta, 0.5+delta) are ~1.4e-5 apart in bary.
    bmin = jnp.array([[-1.0, -1.0, -1e-4]])
    bmax = jnp.array([[0.5, 0.5 + delta, 1e-4]])
    bary, slack = jax.jit(clip_slots_bary_device)(sv0, se1, se2, bmin, bmax)
    b1, b2 = np.asarray(bary[0, :, 0]), np.asarray(bary[0, :, 1])
    p = (np.asarray(sv0)[0] + b1[:, None] * np.asarray(se1)[0]
         + b2[:, None] * np.asarray(se2)[0])
    edge = (np.linalg.norm(np.asarray(se1)[0])
            + np.linalg.norm(np.asarray(se2)[0]))
    pad = float(slack[0]) * edge
    # True clip polygon's AABB (f64): ymax = 0.5 + delta from the merged-
    # away vertex; the padded kept-vertex AABB must still cover it.
    assert p[:, 1].max() + pad >= 0.5 + delta - 1e-9
    assert p[:, 0].max() + pad >= 0.5 - 1e-9
