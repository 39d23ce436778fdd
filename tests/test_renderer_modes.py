"""One small frame through each Renderer mode on the plain XLA route (the
route CPU runs take): static, rebuild (clustered or not), refit, the
binary accel, soft shadows, ray sorting. Each frame must be finite,
count no walk errors, and agree with the static 8-wide render of the same
geometry where the mode does not change the picture."""

import numpy as np
import pytest

from tpurt.app import Renderer
from tpurt.scenes import default_camera_for, deform, teapot_scene
from tpurt.types import Light, RenderConfig

W, H = 40, 30


@pytest.fixture(scope="module")
def scene():
    mesh = teapot_scene(900)
    lights = [Light.directional((0.45, 0.8, 0.3)),
              Light.point(np.asarray(mesh.vertices).mean(0)
                          + np.float32([2.0, 3.0, -1.0]), intensity=0.6)]
    return mesh, default_camera_for(mesh), lights


@pytest.fixture(scope="module")
def static_image(scene):
    mesh, cam, lights = scene
    r = Renderer(mesh, cam, lights,
                 RenderConfig(width=W, height=H, use_kernel=False,
                              leaf_size=4))
    return np.asarray(r.render_frame()["image"])


MODES = {
    "rebuild": ("rebuild", dict()),
    "refit_first_frame": ("refit", dict()),
    "rebuild_unclustered": ("rebuild", dict(rebuild_splits=0)),
    "binary": ("static", dict(bvh_width=2)),
    "sorted_rays": ("static", dict(sort_rays=True)),
    "no_sah": ("static", dict(sah=False)),
}


@pytest.mark.parametrize("name", sorted(MODES))
def test_mode_matches_static_frame(name, scene, static_image):
    mesh, cam, lights = scene
    mode, kw = MODES[name]
    r = Renderer(mesh, cam, lights,
                 RenderConfig(width=W, height=H, use_kernel=False,
                              leaf_size=4, **kw), mode=mode)
    out = r.render_frame()
    img = np.asarray(out["image"])
    assert int(out["trace_errors"]) == 0
    assert np.isfinite(img).all()
    # Same geometry, exact hits: only shading-table quantization (binary
    # walks gather exact normals) and tie-breaks may differ.
    diff = np.abs(img - static_image).max(axis=-1)
    assert (diff > 2e-2).mean() < 0.01, f"{name}: {(diff > 2e-2).mean():.3%}"


def test_refit_mode_animates(scene):
    mesh, cam, lights = scene
    r = Renderer(mesh, cam, lights,
                 RenderConfig(width=W, height=H, use_kernel=False,
                              leaf_size=4), mode="refit")
    first = np.asarray(r.render_frame()["image"])
    r.set_vertices(deform(mesh, 0.4))
    out = r.render_frame()
    assert int(out["trace_errors"]) == 0
    assert r.stats.refit_ms > 0
    assert not np.allclose(first, np.asarray(out["image"]))


def test_soft_shadow_accumulation(scene):
    mesh, cam, _ = scene
    sun = Light.sun((0.45, 0.8, 0.3), angular_radius_deg=6.0)
    r = Renderer(mesh, cam, sun,
                 RenderConfig(width=W, height=H, spp=4, accumulate=True,
                              use_kernel=False, leaf_size=4))
    r.render_frame()
    out = r.render_frame()
    s = np.asarray(out["shadow"])[0][np.asarray(out["valid"])]
    assert int(out["trace_errors"]) == 0
    assert ((s > 0.05) & (s < 0.95)).any(), "no penumbra"


@pytest.mark.parametrize("native_ok", [True, False])
def test_renderer_says_which_accel_it_built(native_ok, scene, monkeypatch,
                                            capsys):
    """The static accel is the native host SBVH; without the native library
    the Renderer builds the on-device LBVH and says so."""
    import tpurt.app as app
    from tpurt import native
    if native_ok and not native.available():
        pytest.skip("native library unavailable")
    monkeypatch.setattr(app, "_sah_available", lambda: native_ok)
    mesh, cam, lights = scene
    r = Renderer(mesh, cam, lights,
                 RenderConfig(width=W, height=H, use_kernel=False,
                              leaf_size=4))
    err = capsys.readouterr().err
    tree = "native host SBVH" if native_ok else "on-device Morton LBVH"
    assert r.accel_kind == f"{tree}, 8-wide, XLA walk"
    assert f"tpurt: accel = {r.accel_kind}" in err
    assert ("native SAH library unavailable" in err) == (not native_ok)
