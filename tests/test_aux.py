"""Auxiliary subsystems (SURVEY.md §5): checkpoint/resume, BVH cache,
metrics, CLI."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh.lbvh import build_lbvh
from tpurt.checkpoint import (load_accumulation, load_bvh, save_accumulation,
                              save_bvh, scene_key)
from tpurt.scenes import random_soup, teapot_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
from tpurt.utils.metrics import FrameStats, Timer, mrays_per_s


def test_accumulation_roundtrip(tmp_path):
    accum = np.random.default_rng(0).normal(size=(16, 16, 3)).astype(np.float32)
    p = os.path.join(tmp_path, "acc.npz")
    save_accumulation(p, accum, frame_index=42, seed=7)
    a, fi, seed = load_accumulation(p)
    np.testing.assert_array_equal(a, accum)
    assert fi == 42 and seed == 7


def test_bvh_cache_roundtrip(tmp_path):
    mesh = random_soup(100, seed=2)
    key = scene_key(np.asarray(mesh.vertices), np.asarray(mesh.indices), 4)
    assert load_bvh(tmp_path, key) is None
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices))
    save_bvh(str(tmp_path), key, bvh)
    back = load_bvh(str(tmp_path), key)
    assert back is not None
    np.testing.assert_array_equal(np.asarray(bvh.nodes_child),
                                  back.nodes_child)
    np.testing.assert_allclose(np.asarray(bvh.nodes_box), back.nodes_box)
    assert back.leaf_size == bvh.leaf_size
    # Key is content-addressed: different geometry -> different key.
    other = random_soup(100, seed=3)
    assert scene_key(np.asarray(other.vertices), np.asarray(other.indices),
                     4) != key


def test_metrics_timer_and_hud():
    t = Timer()
    with t.section("x"):
        sum(range(1000))
    assert t.ms["x"] >= 0
    s = FrameStats(width=64, height=64, mrays_per_s=123.4)
    assert "Mrays/s" in s.hud()
    assert mrays_per_s(2_000_000, 0.02) == 100.0
    assert mrays_per_s(100, 0.0) == 0.0


@pytest.mark.slow
def test_cli_renders_png(tmp_path):
    out = os.path.join(tmp_path, "cli.png")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "tpurt.cli", "--scene", "soup200",
         "--width", "64", "--height", "48", "--no-kernel", "--out", out,
         "--stats-json"],
        capture_output=True, text=True, cwd=REPO, env=env,
        timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["width"] == 64
    assert os.path.exists(out)
    from tpurt.io.image import read_png
    img = read_png(out)
    assert img.shape == (48, 64, 3)


@pytest.mark.slow
def test_renderer_checkpoint_resume(tmp_path):
    """Accumulation checkpoint/resume continues the running mean exactly."""
    import jax
    from tpurt.app import Renderer
    from tpurt.scenes import teapot_scene, default_camera_for
    from tpurt.types import Light, RenderConfig
    mesh = teapot_scene(600)
    cam = default_camera_for(mesh)
    sun = Light.sun((0.45, 0.8, 0.3), angular_radius_deg=6.0)
    cfg = RenderConfig(width=24, height=16, spp=2, use_kernel=False,
                       accumulate=True, seed=3)
    a = Renderer(mesh, cam, sun, cfg)
    for _ in range(2):
        a.render_frame()
    p = os.path.join(tmp_path, "ckpt.npz")
    a.save_state(p)
    want = np.asarray(a.render_frame()["image"])  # frame 3 on original

    b = Renderer(mesh, cam, sun, cfg)
    b.load_state(p)
    got = np.asarray(b.render_frame()["image"])   # frame 3 after resume
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.slow
def test_cli_flag_overrides_preset(tmp_path):
    """Explicit --width/--height must win over a preset's resolution."""
    out = os.path.join(tmp_path, "p.png")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "tpurt.cli", "--scene", "soup200",
         "--preset", "config1", "--width", "40", "--height", "30",
         "--no-kernel", "--out", out, "--stats-json"],
        capture_output=True, text=True, cwd=REPO, env=env,
        timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert (stats["width"], stats["height"]) == (40, 30)
    from tpurt.io.image import read_png
    assert read_png(out).shape == (30, 40, 3)


def test_checked_traverse_sanitizer():
    """checkify sanitizer (SURVEY.md §5): clean scenes pass; the error value
    machinery actually fires on violated checks."""
    import jax
    import jax.numpy as jnp
    from tpurt.bvh.lbvh import build_lbvh
    from tpurt.camera import generate_rays
    from tpurt.scenes import default_camera_for, teapot_scene
    from tpurt.utils.debug import checked_traverse

    mesh = teapot_scene(600)
    cam = default_camera_for(mesh)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices))
    o, d = generate_rays(cam, 24, 16)
    err, (t, tid) = checked_traverse(bvh, o, d)
    assert err.get() is None
    err.throw()  # no-op on success
    assert int((tid >= 0).sum()) > 0

    # Violation detection: t_min above every hit distance flags the
    # "hit distance below t_min" check via a doctored result.
    from jax.experimental import checkify

    def bad(t):
        checkify.check(jnp.all(t > 1e9), "forced failure")
        return t

    err2, _ = jax.jit(checkify.checkify(bad,
                                        errors=checkify.user_checks))(t)
    assert err2.get() is not None and "forced failure" in err2.get()
