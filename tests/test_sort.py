"""Config-5 tests: ray sorting / compaction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.app import render_frame_fn
from tpurt.bvh.lbvh import build_lbvh
from tpurt.passes.sort import (compaction_stats, make_sorted_tracer,
                               ray_sort_keys, sort_rays, unsort)
from tpurt.scenes import default_camera_for, teapot_scene
from tpurt.types import Light, RenderConfig


def _rays(rng, n):
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_sort_clusters_octants(rng):
    o, d = _rays(rng, 4096)
    tm = jnp.full(4096, 1e30)
    smin = jnp.full(3, -5.0)
    smax = jnp.full(3, 5.0)
    so, sd, stm, perm = sort_rays(o, d, tm, smin, smax)
    oct_sorted = np.asarray((sd[:, 0] < 0).astype(np.int32)
                            + 2 * (sd[:, 1] < 0).astype(np.int32)
                            + 4 * (sd[:, 2] < 0).astype(np.int32))
    assert (np.diff(oct_sorted) >= 0).all(), "octants not contiguous"


def test_invalid_rays_sort_last(rng):
    o, d = _rays(rng, 1000)
    tm = jnp.asarray((np.arange(1000) % 3 == 0).astype(np.float32))  # 1/3 valid
    keys = ray_sort_keys(o, d, tm, jnp.full(3, -5.0), jnp.full(3, 5.0))
    so, sd, stm, perm = sort_rays(o, d, tm, jnp.full(3, -5.0), jnp.full(3, 5.0))
    stm = np.asarray(stm)
    first_invalid = np.argmax(stm <= 0)
    assert (stm[first_invalid:] <= 0).all()
    stats = compaction_stats(stm, packet=64)
    assert int(stats["empty_packets"]) >= 8  # trailing packets fully dead


def test_unsort_inverts(rng):
    o, d = _rays(rng, 512)
    tm = jnp.full(512, 1.0)
    so, sd, stm, perm = sort_rays(o, d, tm, jnp.full(3, -5.0), jnp.full(3, 5.0))
    vals = jnp.arange(512, dtype=jnp.int32)
    # vals are in sorted order == f(sorted rays); unsort must align with orig
    restored = unsort(vals, perm, (512,))
    # restored[orig_idx] = position of orig ray in sorted order
    np.testing.assert_array_equal(np.asarray(restored)[np.asarray(perm)],
                                  np.asarray(vals))


@pytest.mark.slow  # ray sorting is an off-by-default variant
def test_sorted_tracer_matches_unsorted(rng):
    mesh = teapot_scene(1200)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices))
    o, d = _rays(rng, 2000)
    tm = jnp.where(jnp.arange(2000) % 4 == 0, 0.0, 1e30)
    from tpurt.bvh.traverse import traverse

    def raw_any(so, sd, stm):
        _, tid = traverse(bvh, so, sd, t_max=stm, any_hit=True)
        return tid >= 0, jnp.int32(0)

    want = np.asarray(raw_any(o, d, tm)[0]) & (np.asarray(tm) > 0)
    tracer = make_sorted_tracer(raw_any, bvh.root_min, bvh.root_max)
    got = np.asarray(tracer(o, d, tm)[0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow  # ray sorting is an off-by-default variant
def test_pipeline_sort_rays_config(rng):
    """Full frame with cfg.sort_rays must equal the unsorted frame."""
    mesh = teapot_scene(1200)
    cam = default_camera_for(mesh)
    lights = (Light.directional((0.45, 0.8, 0.3)),
              Light.directional((-0.4, 0.7, 0.1), intensity=0.5))
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices))
    key = jax.random.PRNGKey(0)
    base = RenderConfig(width=64, height=48, use_kernel=False, bvh_width=2)
    srt = RenderConfig(width=64, height=48, use_kernel=False, bvh_width=2,
                       sort_rays=True)
    a = render_frame_fn(bvh, mesh, cam, lights, key, base)
    b = render_frame_fn(bvh, mesh, cam, lights, key, srt)
    np.testing.assert_allclose(np.asarray(a["image"]), np.asarray(b["image"]),
                               rtol=1e-5, atol=1e-6)
