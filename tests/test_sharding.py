"""Stage-8 tests: multi-chip pixel-tile sharding on the fake 8-device CPU
mesh (SURVEY.md §4.5 — the distributed test without a cluster)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.app import render_frame_fn
from tpurt.bvh.lbvh import build_lbvh
from tpurt.camera import camera_rays
from tpurt.parallel.tiling import (device_put_replicated, make_tile_mesh,
                                   render_frame_sharded, shard_rays,
                                   sharded_frames)
from tpurt.scenes import default_camera_for, teapot_scene
from tpurt.types import Light, RenderConfig

pytestmark = pytest.mark.slow  # compile-heavy: full-suite tier only


@pytest.fixture(scope="module")
def scene():
    mesh = teapot_scene(1000)
    cam = default_camera_for(mesh)
    light = Light.directional((0.45, 0.8, 0.3))
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                     leaf_size=4)
    return mesh, cam, light, bvh


def test_eight_fake_devices_present():
    assert len(jax.devices()) == 8, (
        "conftest must provide 8 fake CPU devices")


def test_sharded_matches_single_device(scene):
    mesh, cam, light, bvh = scene
    cfg = RenderConfig(width=64, height=48, use_kernel=False, bvh_width=2)
    key = jax.random.PRNGKey(0)
    rays = camera_rays(cam, cfg.width, cfg.height)
    want = np.asarray(render_frame_fn(bvh, mesh, cam, (light,), key,
                                      cfg, rays=rays)["image"])
    dev_mesh = make_tile_mesh()
    img, errors = render_frame_sharded(bvh, mesh, cam, (light,), key, cfg,
                                       rays, mesh=dev_mesh)
    assert int(errors) == 0
    got = np.asarray(img)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_output_is_row_sharded(scene):
    mesh, cam, light, bvh = scene
    cfg = RenderConfig(width=64, height=64, use_kernel=False, bvh_width=2)
    dev_mesh = make_tile_mesh()
    mesh_r = device_put_replicated(mesh, dev_mesh)
    bvh_r = device_put_replicated(bvh, dev_mesh)
    rays = shard_rays(camera_rays(cam, 64, 64), dev_mesh)
    img, _ = render_frame_sharded(bvh_r, mesh_r, cam, (light,),
                                  jax.random.PRNGKey(0), cfg, rays,
                                  mesh=dev_mesh)
    # 64 rows over 8 devices -> each shard holds 8 rows.
    shard_shapes = {s.data.shape for s in img.addressable_shards}
    assert shard_shapes == {(8, 64, 3)}


def test_sharded_height_not_divisible(scene):
    mesh, cam, light, bvh = scene
    cfg = RenderConfig(width=32, height=30, use_kernel=False, bvh_width=2)  # 30 % 8 != 0
    img, _ = render_frame_sharded(bvh, mesh, cam, (light,),
                                  jax.random.PRNGKey(0), cfg,
                                  camera_rays(cam, 32, 30),
                                  mesh=make_tile_mesh())
    assert np.asarray(img).shape == (30, 32, 3)
    assert np.isfinite(np.asarray(img)).all()


def test_sharded_pallas_matches_single_device(scene):
    """The 8-wide accel's walk + shade table under shard_map must agree
    with the unsharded frame (on the card the walk is the CUDA kernel; here
    its XLA twin)."""
    from tpurt.bvh.wide import build_wide
    from tpurt.passes.shading import make_shade_table
    mesh, cam, light, bvh = scene
    wide, st = build_wide(bvh), make_shade_table(bvh, mesh)
    cfg = RenderConfig(width=64, height=48, use_kernel=False, leaf_size=4)
    key = jax.random.PRNGKey(0)
    rays = camera_rays(cam, cfg.width, cfg.height)
    want = np.asarray(render_frame_fn(wide, mesh, cam, (light,), key, cfg,
                                      shade_table=st, rays=rays)["image"])
    img, errors = render_frame_sharded(wide, mesh, cam, (light,), key, cfg,
                                       rays, mesh=make_tile_mesh(),
                                       shade_table=st)
    got = np.asarray(img)
    assert got.shape == want.shape and int(errors) == 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_soft_shadows_decorrelated(scene):
    """Each shard folds its axis index into the RNG: the penumbra jitter
    must not repeat identically across shards."""
    mesh, cam, _, bvh = scene
    sun = Light.sun((0.45, 0.8, 0.3), angular_radius_deg=20.0)
    # 1 row of pixels per shard, looking at the same geometry: identical
    # shard RNG would produce identical penumbra rows.
    cfg = RenderConfig(width=64, height=8, spp=1, use_kernel=False, bvh_width=2)
    img = np.asarray(render_frame_sharded(bvh, mesh, cam, (sun,),
                                          jax.random.PRNGKey(3), cfg,
                                          camera_rays(cam, 64, 8),
                                          mesh=make_tile_mesh())[0])
    assert np.isfinite(img).all()
    # Compare each shard's row against every other: some penumbra pixels
    # exist (cone angle 20 deg) and rows must not be bitwise-identical.
    rows = img.reshape(8, -1)
    distinct = {rows[i].tobytes() for i in range(8)}
    assert len(distinct) > 1, "shards drew identical shadow jitter"


def test_sharded_sponza_scale_production_paths(scene):
    """Sharded parity at realistic scale: procedural Sponza interior, two
    lights, the 8-wide accel + shade table under the 8-device mesh, vs the
    unsharded frame."""
    from tpurt.bvh.wide import build_wide
    from tpurt.passes.shading import make_shade_table
    from tpurt.scenes import sponza_interior_camera, sponza_scene
    mesh = sponza_scene(8_000)
    cam = sponza_interior_camera()
    lights = (Light.directional((0.25, 0.9, 0.2)),
              Light.directional((-0.4, 0.8, -0.3), color=(0.7, 0.8, 1.0),
                                intensity=0.5))
    cfg = RenderConfig(width=320, height=180, use_kernel=False, leaf_size=8)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                     leaf_size=8)
    wide = build_wide(bvh)
    st = make_shade_table(bvh, mesh)
    key = jax.random.PRNGKey(0)
    rays = camera_rays(cam, cfg.width, cfg.height)
    want = np.asarray(render_frame_fn(wide, mesh, cam, lights, key, cfg,
                                      shade_table=st, rays=rays)["image"])
    img, _ = render_frame_sharded(wide, mesh, cam, lights, key, cfg, rays,
                                  mesh=make_tile_mesh(), shade_table=st)
    np.testing.assert_allclose(np.asarray(img), want, rtol=1e-4, atol=1e-5)


def test_pure_jax_sharded_path_is_vma_checked(scene, monkeypatch):
    """The sharded render always runs with check_vma=True."""
    mesh, cam, light, bvh = scene
    seen = {}
    real = jax.shard_map

    def spy(f=None, /, **kw):
        seen["check_vma"] = kw.get("check_vma")
        return real(f, **kw) if f is not None else real(**kw)

    monkeypatch.setattr(jax, "shard_map", spy)
    cfg = RenderConfig(width=32, height=16, use_kernel=False, bvh_width=2)
    img, _ = render_frame_sharded(bvh, mesh, cam, (light,),
                                  jax.random.PRNGKey(0), cfg,
                                  camera_rays(cam, 32, 16),
                                  mesh=make_tile_mesh())
    assert np.isfinite(np.asarray(img)).all()
    assert seen["check_vma"] is True


def test_sharded_frames_match_renderer(scene):
    """The --shard path (sharded_frames) renders a static Renderer's frame
    from the Renderer's own rays: the image equals the one-device frame."""
    from tpurt.app import Renderer
    mesh, cam, light, _ = scene
    r = Renderer(mesh, cam, light, RenderConfig(width=48, height=36,
                                                use_kernel=False,
                                                leaf_size=4))
    want = np.asarray(r.render_frame()["image"])
    frame = sharded_frames(r, jax.devices()[:4])
    img, errors = frame(jax.random.PRNGKey(0))
    assert int(errors) == 0
    assert {s.data.shape for s in img.addressable_shards} == {(9, 48, 3)}
    np.testing.assert_allclose(np.asarray(img), want, rtol=1e-5, atol=1e-6)


def _graft_entry():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("__graft_entry__", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_multichip_entry():
    _graft_entry().dryrun_multichip(8, use_kernel=False)


def test_entry_compiles():
    fn, args = _graft_entry().entry(use_kernel=False)
    img = jax.jit(fn)(*args)
    assert img.shape == (256, 256, 3)
    assert np.isfinite(np.asarray(img)).all()


def test_cli_shard_flag(tmp_path):
    """--shard N drives the SURVEY §2.4 data-parallel path from the CLI:
    rows sharded over the fake 8-device mesh, PNG written, and the image
    matches the unsharded CLI render of the same scene/seed."""
    from tpurt.cli import main
    from tpurt.io.image import read_png
    a = str(tmp_path / "sharded.png")
    b = str(tmp_path / "single.png")
    base = ["--scene", "soup200", "--width", "64", "--height", "48",
            "--no-kernel", "--no-sah", "--seed", "0"]
    assert main(base + ["--shard", "8", "--out", a]) == 0
    assert main(base + ["--out", b]) == 0
    ia, ib = read_png(a), read_png(b)
    assert ia.shape == ib.shape == (48, 64, 3)
    np.testing.assert_allclose(ia.astype(np.float32),
                               ib.astype(np.float32), atol=1.5)


def test_cli_shard_rejects_nonstatic():
    from tpurt.cli import main
    with pytest.raises(SystemExit):
        main(["--scene", "soup200", "--width", "32", "--height", "32",
              "--no-kernel", "--shard", "8", "--mode", "refit"])
