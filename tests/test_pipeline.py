"""Stage-3/6 tests: the full JAX pipeline (G-buffer -> shadow -> composite)
against an independently-computed oracle image, plus the Renderer app shell.

This is the analogue of the reference's visual verification + its
compute-vs-hardware cross-check (SURVEY.md §4): the whole-pipeline image must
match a brute-force render pixel-for-pixel within tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt import Camera, Light, RenderConfig
from tpurt.app import Renderer, render_frame_fn
from tpurt.bvh.lbvh import build_lbvh
from tpurt.bvh.reference import brute_force_any, brute_force_closest
from tpurt.camera import generate_rays
from tpurt.scenes import default_camera_for, deform, teapot_scene

pytestmark = pytest.mark.slow  # compile-heavy: full-suite tier only

W, H = 64, 48


@pytest.fixture(scope="module")
def scene():
    mesh = teapot_scene(1500)
    cam = default_camera_for(mesh)
    light = Light.directional((0.45, 0.8, 0.3))
    return mesh, cam, light


def oracle_image(mesh, cam, light, cfg):
    """Brute-force reference render (NumPy), independent of all JAX passes."""
    o, d = generate_rays(cam, cfg.width, cfg.height)
    o = np.asarray(o).reshape(-1, 3)
    d = np.asarray(d).reshape(-1, 3)
    t, tid = brute_force_closest(mesh, o, d)
    valid = tid >= 0
    pos = o + d * np.where(valid, t, 0.0)[:, None]
    idx = np.asarray(mesh.indices)
    verts = np.asarray(mesh.vertices)
    nrms = np.asarray(mesh.normals)
    alb = np.zeros_like(pos)
    smooth = np.zeros_like(pos)
    gn = np.zeros_like(pos)
    for i in np.nonzero(valid)[0]:
        tri = idx[tid[i]]
        v0, v1, v2 = verts[tri]
        e1, e2 = v1 - v0, v2 - v0
        w = pos[i] - v0
        d11, d12, d22 = e1 @ e1, e1 @ e2, e2 @ e2
        dw1, dw2 = w @ e1, w @ e2
        det = max(d11 * d22 - d12 * d12, 1e-20)
        u = np.clip((d22 * dw1 - d12 * dw2) / det, 0, 1)
        v = np.clip((d11 * dw2 - d12 * dw1) / det, 0, 1)
        n0, n1, n2 = nrms[tri]
        sn = n0 + u * (n1 - n0) + v * (n2 - n0)
        sn /= max(np.linalg.norm(sn), 1e-12)
        g = np.cross(e1, e2)
        g /= max(np.linalg.norm(g), 1e-12)
        face = np.sign(-g @ d[i]) or 1.0
        smooth[i] = sn * face
        gn[i] = g * face
        alb[i] = np.asarray(mesh.albedo)[tid[i]]
    L = np.asarray(light.direction)
    sh_o = pos + gn * cfg.shadow_bias
    occ = np.zeros(len(o), bool)
    vidx = np.nonzero(valid)[0]
    occ[vidx] = brute_force_any(mesh, sh_o[vidx], np.tile(L, (len(vidx), 1)))
    shadow = np.where(occ, 0.0, 1.0)
    ndl = np.clip((smooth * L).sum(-1), 0, None)
    img = alb * (ndl * shadow + cfg.ambient)[:, None]
    img[~valid] = cfg.background
    return img.reshape(cfg.height, cfg.width, 3), shadow.reshape(cfg.height, cfg.width), valid.reshape(cfg.height, cfg.width)


def test_full_pipeline_matches_oracle(scene):
    mesh, cam, light = scene
    cfg = RenderConfig(width=W, height=H, use_kernel=False, bvh_width=2)
    want_img, want_shadow, want_valid = oracle_image(mesh, cam, light, cfg)

    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                     leaf_size=cfg.leaf_size)
    out = render_frame_fn(bvh, mesh, cam, (light,),
                          jax.random.PRNGKey(0), cfg)
    got_img = np.asarray(out["image"])
    got_valid = np.asarray(out["valid"])

    np.testing.assert_array_equal(got_valid, want_valid)
    # Pixels at silhouette/shadow boundaries may disagree due to fp ordering;
    # allow a small fraction of outliers, tight tolerance elsewhere.
    diff = np.abs(got_img - want_img).max(axis=-1)
    frac_bad = (diff > 2e-2).mean()
    assert frac_bad < 0.01, f"{frac_bad:.3%} mismatched pixels"
    got_shadow = np.asarray(out["shadow"])[0]
    shadow_disagree = (np.abs(got_shadow - want_shadow) > 0.5).mean()
    assert shadow_disagree < 0.01


def test_renderer_shell_modes(scene):
    mesh, cam, light = scene
    cfg = RenderConfig(width=32, height=24, use_kernel=False, bvh_width=2)
    r = Renderer(mesh, cam, light, cfg, mode="refit")
    out1 = r.render_frame()
    assert out1["image"].shape == (24, 32, 3)
    assert r.stats.build_ms > 0
    # Animate and refit.
    r.set_vertices(deform(mesh, 0.5))
    out2 = r.render_frame()
    assert r.stats.refit_ms > 0
    assert not np.allclose(np.asarray(out1["image"]),
                           np.asarray(out2["image"]))
    hud = r.stats.hud()
    assert "Mrays/s" in hud


def test_renderer_profile_mode(scene):
    mesh, cam, light = scene
    cfg = RenderConfig(width=32, height=24, use_kernel=False, bvh_width=2)
    r = Renderer(mesh, cam, light, cfg)
    r.render_frame(profile=True)
    assert r.stats.gbuffer_ms > 0
    assert r.stats.shadow_ms > 0
    assert r.stats.composite_ms > 0


def test_soft_shadows_bracket_hard(scene):
    """Cone-light soft shadows must average to values in [0,1] and produce
    penumbra (some strictly-between values) where hard shadows are binary."""
    mesh, cam, _ = scene
    sun = Light.sun((0.45, 0.8, 0.3), angular_radius_deg=8.0)
    cfg = RenderConfig(width=48, height=36, spp=8, use_kernel=False, bvh_width=2)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices))
    out = render_frame_fn(bvh, mesh, cam, (sun,), jax.random.PRNGKey(1), cfg)
    s = np.asarray(out["shadow"])[0][np.asarray(out["valid"])]
    assert (s >= 0).all() and (s <= 1).all()
    assert ((s > 0.05) & (s < 0.95)).any(), "no penumbra found"


def test_multi_light_additive(scene):
    mesh, cam, _ = scene
    l1 = Light.directional((0.45, 0.8, 0.3), intensity=0.7)
    l2 = Light.directional((-0.5, 0.7, -0.2), color=(1.0, 0.8, 0.6),
                           intensity=0.5)
    cfg = RenderConfig(width=32, height=24, use_kernel=False, bvh_width=2, ambient=0.0)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices))
    both = render_frame_fn(bvh, mesh, cam, (l1, l2), jax.random.PRNGKey(0), cfg)
    only1 = render_frame_fn(bvh, mesh, cam, (l1,), jax.random.PRNGKey(0), cfg)
    only2 = render_frame_fn(bvh, mesh, cam, (l2,), jax.random.PRNGKey(0), cfg)
    v = np.asarray(both["valid"])
    add = np.asarray(only1["image"]) + np.asarray(only2["image"])
    np.testing.assert_allclose(np.asarray(both["image"])[v], add[v],
                               rtol=1e-4, atol=1e-5)


def test_accumulation_converges(scene):
    mesh, cam, _ = scene
    sun = Light.sun((0.45, 0.8, 0.3), angular_radius_deg=6.0)
    cfg = RenderConfig(width=24, height=16, spp=2, use_kernel=False, bvh_width=2,
                       accumulate=True)
    r = Renderer(mesh, cam, sun, cfg)
    imgs = [np.asarray(r.render_frame()["image"]) for _ in range(3)]
    # Accumulated frames differ (new samples) but deltas shrink.
    d01 = np.abs(imgs[1] - imgs[0]).mean()
    d12 = np.abs(imgs[2] - imgs[1]).mean()
    assert d01 > 0
    assert d12 <= d01 + 1e-6


def test_point_light_distance_limit():
    """A point light between occluder and receiver: geometry BEYOND the light
    must not occlude (t_max = distance-to-light)."""
    from tpurt.scenes import make_plane, merge_meshes
    ground = make_plane(center=(0, 0, 0), size=(4, 4))
    ceiling = make_plane(center=(0, 3.0, 0), size=(4, 4))
    mesh = merge_meshes([ground, ceiling])
    cam = Camera.look_at((0, 1.2, 3.5), (0, 0.3, 0), fov_y_deg=50)
    light = Light.point((0, 1.5, 0), intensity=3.0)
    cfg = RenderConfig(width=32, height=24, use_kernel=False, bvh_width=2)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices))
    out = render_frame_fn(bvh, mesh, cam, (light,), jax.random.PRNGKey(0), cfg)
    valid = np.asarray(out["valid"])
    shadow = np.asarray(out["shadow"])[0]
    # The ceiling is beyond the light from the ground's perspective: every
    # valid ground pixel must be lit.
    assert shadow[valid].min() == 1.0


def test_renderer_rebuild_mode_fused(scene):
    """mode="rebuild" with the 8-wide accel runs the fused
    build+collapse program with a CACHED pad (no per-frame count sync) and
    must keep producing the same image as a static render."""
    mesh, cam, light = scene
    cfg = RenderConfig(width=32, height=24, use_kernel=False, leaf_size=4)
    r_static = Renderer(mesh, cam, light, cfg, mode="static")
    want = np.asarray(r_static.render_frame()["image"])
    r = Renderer(mesh, cam, light, cfg, mode="rebuild")
    assert r._nw_pad is not None, "wide path should be active"
    img1 = np.asarray(r.render_frame()["image"])
    img2 = np.asarray(r.render_frame()["image"])
    np.testing.assert_allclose(img1, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(img2, want, rtol=1e-5, atol=1e-6)


def test_renderer_refit_mode_clip(scene):
    """mode="refit" with the 8-wide accel runs the fused clip-geometry
    refit (bvh/clip_refit.py): after an animation step the image must match
    a fresh-build static render of the deformed mesh (boxes only cull;
    triangle tests decide, so conservative refit boxes change nothing
    except closest-hit tie order at shared edges)."""
    mesh, cam, light = scene
    cfg = RenderConfig(width=32, height=24, use_kernel=False, leaf_size=4)
    r = Renderer(mesh, cam, light, cfg, mode="refit")
    assert r._nw_pad is not None, "wide path should be active"
    assert r._clip_plan is not None, "clip-refit plan should be active"
    r.render_frame()
    r.set_vertices(deform(mesh, 0.37))
    out = r.render_frame()
    assert r.stats.refit_ms > 0
    r2 = Renderer(mesh, cam, light, cfg, mode="static")
    r2.set_vertices(deform(mesh, 0.37))
    r2.bvh = r2._build_jit(r2.mesh.vertices, r2.mesh.indices)
    r2.accel = r2._make_accel()
    want = np.asarray(r2.render_frame()["image"])
    diff = np.abs(np.asarray(out["image"]) - want).max(axis=-1)
    assert (diff > 2e-2).mean() < 0.01, \
        f"{(diff > 2e-2).mean():.3%} mismatched pixels after clip refit"


def test_renderer_rebuild_overflow_recovery(scene):
    """If animation grows the wide-node count past the cached pad, the
    rebuild path must detect the on-device overflow and re-plan — never
    render from a truncated collapse."""
    mesh, cam, light = scene
    cfg = RenderConfig(width=32, height=24, use_kernel=False, leaf_size=4)
    r = Renderer(mesh, cam, light, cfg, mode="rebuild")
    assert r._nw_pad is not None
    from tpurt.bvh.wide import count_wide
    # The rebuild path's frontier: the fixed depth-3 cut.
    true_count = count_wide(r.bvh, mode="fixed")
    # Force an undersized pad (as if geometry grew), then animate: the
    # rebuild must notice count > pad and recover via a full re-plan.
    r._nw_pad = max(1, true_count - 1)
    r.set_vertices(deform(mesh, 0.21))
    out = r.render_frame()
    assert r._nw_pad >= true_count - 1  # re-planned (bucketed) or unchanged
    # Ground truth: a fresh static renderer on the deformed mesh.
    mesh2 = dataclasses.replace(mesh)
    r2 = Renderer(mesh, cam, light, cfg, mode="static")
    r2.set_vertices(deform(mesh, 0.21))
    r2.bvh = r2._build_jit(r2.mesh.vertices, r2.mesh.indices)
    r2.accel = r2._make_accel()
    want = np.asarray(r2.render_frame()["image"])
    np.testing.assert_allclose(np.asarray(out["image"]), want,
                               rtol=1e-5, atol=1e-6)


def test_rebuild_mode_shade_table_follows_geometry(scene):
    """Rebuild mode: the shade table rides the per-frame rebuild, and a
    deformed frame must match a fresh static render of the same
    geometry."""
    mesh, cam, light = scene
    cfg = RenderConfig(width=64, height=48, use_kernel=False)
    r = Renderer(mesh, cam, light, cfg, mode="rebuild")
    r.set_vertices(deform(mesh, time=0.3))
    img = np.asarray(r.render_frame()["image"])
    assert r.shade_table.shape[0] == r.accel.tri_id.shape[0]
    m2 = r.mesh
    r_static = Renderer(
        dataclasses.replace(m2, vertices=np.asarray(m2.vertices),
                            normals=np.asarray(m2.normals)),
        cam, light, dataclasses.replace(cfg, sah=False))
    want = np.asarray(r_static.render_frame()["image"])
    diff = np.abs(img - want).max(axis=-1)
    assert (diff > 2e-2).mean() < 0.01
