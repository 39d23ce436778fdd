"""Host-side logic of the CUDA traversal wrapper (tpurt/kernels/traverse.py)
that runs without a card: ray packing, launch geometry, accel checks, the
route choice in app.make_tracers, and the refusal to run off a GPU. The
kernel itself is tested on the card (tests/test_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.kernels import traverse as kt


@pytest.mark.parametrize("shape,want", [
    ((1080, 1920), (1920, 1080, 8)),      # image grid: 8 x 4 warp tiles
    ((37,), (37, 1, 32)),                 # flat list: 32 x 1 warp tiles
    ((2, 3, 5), (5, 6, 8)),               # leading axes fold into height
    ((3, 10), (10, 3, 32)),               # too short for 4-row tiles
    ((), (1, 1, 32)),
])
def test_launch_geometry(shape, want):
    width, height, tile_w = kt.launch_geometry(shape)
    assert (width, height, tile_w) == want
    assert 32 % tile_w == 0


def test_pack_rays_layout(rng):
    o = rng.normal(size=(3, 5, 3)).astype(np.float32)
    d = rng.normal(size=(3, 5, 3)).astype(np.float32)
    tm = rng.uniform(0, 9, (3, 5)).astype(np.float32)
    rays = np.asarray(kt.pack_rays(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tm)))
    assert rays.shape == (15, 8) and rays.dtype == np.float32
    np.testing.assert_array_equal(rays[:, 0:3], o.reshape(-1, 3))
    np.testing.assert_array_equal(rays[:, 3:6], d.reshape(-1, 3))
    np.testing.assert_array_equal(rays[:, 6], tm.reshape(-1))
    assert (rays[:, 7] == 0).all()
    # A scalar t_max broadcasts to every ray.
    r2 = np.asarray(kt.pack_rays(jnp.asarray(o), jnp.asarray(d), 2.5))
    assert (r2[:, 6] == 2.5).all()


def test_accel_checks():
    from tpurt.bvh.lbvh import build_lbvh
    from tpurt.bvh.wide import build_wide
    from tpurt.scenes import random_soup
    mesh = random_soup(60, seed=0)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                     leaf_size=4)
    with pytest.raises(TypeError, match="WideBVH"):
        kt._check_accel(bvh)
    wide = build_wide(bvh)
    kt._check_accel(wide)
    import dataclasses
    with pytest.raises(ValueError, match="leaf_size"):
        kt._check_accel(dataclasses.replace(wide, leaf_size=15))
    with pytest.raises(ValueError, match="stack_depth"):
        kt._check_accel(dataclasses.replace(wide, stack_depth=100))


def test_kernel_route_refuses_cpu():
    """Asking for the kernel off a GPU raises and returns nothing — no
    silent fallback to the XLA walk."""
    from tpurt.bvh.lbvh import build_lbvh
    from tpurt.bvh.wide import build_wide
    from tpurt.scenes import random_soup
    assert jax.devices()[0].platform == "cpu"
    mesh = random_soup(40, seed=1)
    wide = build_wide(build_lbvh(jnp.asarray(mesh.vertices),
                                 jnp.asarray(mesh.indices), leaf_size=4))
    o = jnp.zeros((4, 3))
    d = jnp.ones((4, 3))
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        kt.trace_closest_cuda(wide, o, d)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        kt.trace_any_cuda(wide, o, d, 1.0)
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        kt.build_library()


def test_renderer_kernel_route_refuses_cpu():
    from tpurt.app import Renderer
    from tpurt.scenes import default_camera_for, random_soup
    from tpurt.types import Light, RenderConfig
    mesh = random_soup(40, seed=2)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        Renderer(mesh, default_camera_for(mesh),
                 Light.directional((0, 1, 0)),
                 RenderConfig(width=8, height=8))
    with pytest.raises(ValueError, match="8-wide"):
        Renderer(mesh, default_camera_for(mesh),
                 Light.directional((0, 1, 0)),
                 RenderConfig(width=8, height=8, bvh_width=2))


def test_make_tracers_route_choice():
    """use_kernel picks the CUDA wrappers for the wide accel; the binary
    accel has no kernel and refuses it."""
    from tpurt.app import make_tracers
    from tpurt.bvh.lbvh import build_lbvh
    from tpurt.scenes import random_soup
    from tpurt.types import RenderConfig
    mesh = random_soup(40, seed=3)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                     leaf_size=4)
    closest, any_ = make_tracers(RenderConfig(use_kernel=True))
    o = jnp.zeros((4, 3))
    d = jnp.ones((4, 3))
    with pytest.raises(ValueError, match="8-wide"):
        closest(bvh, o, d)
    with pytest.raises(ValueError, match="8-wide"):
        any_(bvh, o, d, 1.0)
    closest, any_ = make_tracers(RenderConfig(use_kernel=False))
    t, tid, sidx, err = closest(bvh, o, d)
    assert sidx is None and tid.shape == (4,) and int(err) == 0
