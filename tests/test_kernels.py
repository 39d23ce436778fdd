"""The 8-wide walk (bvh/traverse.traverse_wide, the plain twin of the CUDA
kernel and the route every CPU run takes) against the binary JAX traversal,
plus the CUDA wrapper's host-side logic: ray packing, launch geometry,
accel checks, and its refusal to run off a GPU. The kernel itself runs on
the card: tests/test_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh.lbvh import build_lbvh
from tpurt.bvh.traverse import traverse, traverse_wide
from tpurt.bvh.wide import build_wide
from tpurt.scenes import random_soup, teapot_scene


def _build(mesh, leaf_size=4):
    return build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                      leaf_size=leaf_size)


def _rays(rng, n, extent=8.0):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def trace_closest_wide(bvh, o, d, t_max=jnp.inf):
    """(t, original tri_id) from the wide walk of ``bvh``'s 8-wide rows."""
    wide = build_wide(bvh)
    t, sidx, errors = traverse_wide(wide, jnp.asarray(o), jnp.asarray(d),
                                    t_max=t_max)
    assert int(errors) == 0
    tid = jnp.where(sidx >= 0, wide.tri_id[jnp.maximum(sidx, 0)], -1)
    return t, tid


def trace_any_wide(bvh, o, d, t_max, t_min=0.0):
    _, sidx, errors = traverse_wide(build_wide(bvh), jnp.asarray(o),
                                    jnp.asarray(d), t_min=t_min,
                                    t_max=t_max, any_hit=True)
    assert int(errors) == 0
    return sidx >= 0


# ---------------------------------------------------------------------------
# Wide walk vs binary JAX traversal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf_size", [1, 4, 8, 14])
def test_closest_matches_jax_traversal(leaf_size, rng):
    mesh = random_soup(150, seed=leaf_size)
    bvh = _build(mesh, leaf_size=leaf_size)
    o, d = _rays(rng, 700)
    t_ref, id_ref = traverse(bvh, jnp.asarray(o), jnp.asarray(d))
    t_k, id_k = trace_closest_wide(bvh, o, d)
    np.testing.assert_allclose(np.asarray(t_ref), np.asarray(t_k),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(id_ref), np.asarray(id_k))


def test_any_hit_matches_jax_traversal(rng):
    mesh = teapot_scene(2000)
    bvh = _build(mesh, leaf_size=8)
    o, d = _rays(rng, 1024, extent=6.0)
    _, id_ref = traverse(bvh, jnp.asarray(o), jnp.asarray(d), t_min=1e-4,
                         any_hit=True)
    occ = trace_any_wide(bvh, o, d, t_max=jnp.full(1024, 3e38), t_min=1e-4)
    np.testing.assert_array_equal(np.asarray(id_ref) >= 0, np.asarray(occ))


def test_any_hit_respects_tmax(rng):
    mesh = random_soup(120, seed=5)
    bvh = _build(mesh)
    o, d = _rays(rng, 512)
    t_ref, _ = traverse(bvh, jnp.asarray(o), jnp.asarray(d))
    t_ref = np.asarray(t_ref)
    # t_max just below each closest hit -> only rays with a second, nearer...
    # no: any hit in (0, tmax); cutting below the closest t of the FIRST hit
    # may still find others? closest is minimal -> no hit possible.
    tmax = np.where(np.isfinite(t_ref), t_ref * 0.999, 0.5).astype(np.float32)
    occ = trace_any_wide(bvh, o, d, t_max=jnp.asarray(tmax))
    occ = np.asarray(occ)
    assert not occ[np.isfinite(t_ref)].any()


def test_inactive_rays_skip(rng):
    mesh = random_soup(80, seed=6)
    bvh = _build(mesh)
    o, d = _rays(rng, 256)
    occ = trace_any_wide(bvh, o, d, t_max=jnp.zeros(256))
    assert not np.asarray(occ).any()


def test_image_shaped_rays(rng):
    """(H, W, 3) ray grids keep their shape through the flat walk."""
    mesh = teapot_scene(300)
    bvh = _build(mesh)
    from tpurt.scenes import default_camera_for
    from tpurt.camera import generate_rays
    cam = default_camera_for(mesh)
    o, d = generate_rays(cam, 40, 36)
    t_ref, id_ref = traverse(bvh, o, d)
    t_k, id_k = trace_closest_wide(bvh, o, d)
    assert t_k.shape == (36, 40)
    np.testing.assert_allclose(np.asarray(t_ref), np.asarray(t_k),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(id_ref), np.asarray(id_k))


def test_full_pipeline_with_pallas_tracers(rng):
    """render_frame_fn on the 8-wide accel (XLA wide walk + shade table)
    == render_frame_fn on the binary LBVH (XLA binary walk)."""
    from tpurt.app import render_frame_fn
    from tpurt.passes.shading import make_shade_table
    from tpurt.scenes import default_camera_for
    from tpurt.types import Light, RenderConfig
    mesh = teapot_scene(1200)
    cam = default_camera_for(mesh)
    light = Light.directional((0.45, 0.8, 0.3))
    bvh = _build(mesh, leaf_size=8)
    key = jax.random.PRNGKey(0)
    a = render_frame_fn(build_wide(bvh), mesh, cam, (light,), key,
                        RenderConfig(width=64, height=48, use_kernel=False,
                                     leaf_size=8),
                        shade_table=make_shade_table(bvh, mesh))
    b = render_frame_fn(bvh, mesh, cam, (light,), key,
                        RenderConfig(width=64, height=48, use_kernel=False,
                                     leaf_size=8, bvh_width=2))
    assert int(a["trace_errors"]) == int(b["trace_errors"]) == 0
    # Same hits and shadows exactly; the image differs only by the shade
    # table's octahedral normal encoding (the binary route gathers the
    # mesh's own normals).
    for k in ("valid", "tri_id", "shadow"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    np.testing.assert_allclose(np.asarray(a["image"]), np.asarray(b["image"]),
                               rtol=1e-4, atol=5e-3)


def test_scene_exit_t_cap_preserves_occlusion(rng):
    """Capping directional shadow rays at the scene-AABB exit cannot change
    any occlusion result (no occluder exists outside the root box)."""
    from tpurt.passes.shadow import scene_exit_t
    from tpurt.scenes import default_camera_for
    from tpurt.camera import generate_rays
    mesh = teapot_scene(1200)
    bvh = _build(mesh, leaf_size=8)
    cam = default_camera_for(mesh)
    o, d = generate_rays(cam, 64, 48)
    t_ref, id_ref = traverse(bvh, o, d)
    # shadow-style origins: surface points nudged off the geometry
    valid = np.asarray(id_ref) >= 0
    pos = np.asarray(o) + np.asarray(d) * np.where(valid, np.asarray(t_ref),
                                                   0.0)[..., None]
    ldir = np.float32([0.45, 0.8, 0.3])
    ldir /= np.linalg.norm(ldir)
    so = jnp.asarray(pos + 1e-3 * ldir)
    sd = jnp.broadcast_to(jnp.asarray(ldir), so.shape)
    cap = scene_exit_t(so, sd, (bvh.root_min, bvh.root_max))
    assert bool(jnp.all(cap >= 0.0))
    occ_inf = trace_any_wide(bvh, so, sd,
                             jnp.where(jnp.asarray(valid), 3.4e38, 0.0))
    occ_cap = trace_any_wide(bvh, so, sd,
                             jnp.where(jnp.asarray(valid), cap, 0.0))
    np.testing.assert_array_equal(np.asarray(occ_inf), np.asarray(occ_cap))
