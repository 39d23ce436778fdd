"""GPU-marked tests: the CUDA kernel against its plain XLA twin on the card.

They skip off a GPU (the ``gpu`` fixture decides, per test) and run on the
card inside chip_smoke.py (phase 6): ``python chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tpurt.bvh.lbvh import build_lbvh
from tpurt.bvh.traverse import traverse_wide
from tpurt.bvh.wide import build_wide
from tpurt.camera import generate_rays
from tpurt.scenes import default_camera_for, random_soup, teapot_scene

pytestmark = pytest.mark.gpu


def _wide(mesh, leaf_size=14):
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                     leaf_size=leaf_size)
    return build_wide(bvh)


def test_kernel_matches_xla_walk_1080p(gpu):
    """Closest and any hit at 1080p: the kernel against the XLA wide walk
    of the same accel (tolerances as chip_smoke.py phase 3)."""
    from tpurt.kernels.traverse import trace_any_cuda, trace_closest_cuda
    mesh = teapot_scene(20_000)
    wide = _wide(mesh)
    o, d = generate_rays(default_camera_for(mesh), 1920, 1080)
    tk, sk, ek = trace_closest_cuda(wide, o, d)
    tx, sx, ex = traverse_wide(wide, o, d)
    sk, sx = np.asarray(sk), np.asarray(sx)
    valid = (sk >= 0) | (sx >= 0)
    assert valid.mean() > 0.1
    assert (sk == sx)[valid].mean() >= 0.9999
    same = (sk == sx) & (sx >= 0)
    rel = np.abs(np.asarray(tk)[same] - np.asarray(tx)[same]) \
        / np.asarray(tx)[same]
    assert rel.max() <= 1e-5
    ldir = jnp.asarray([0.45, 0.8, 0.3]) / np.linalg.norm([0.45, 0.8, 0.3])
    hit = jnp.asarray(sx >= 0)
    so = o + d * jnp.where(hit, tx, 0.0)[..., None] + 1e-3 * ldir
    sd = jnp.broadcast_to(ldir, so.shape)
    tm = jnp.where(hit, 3.4e38, 0.0)
    occ, eak = trace_any_cuda(wide, so, sd, tm)
    _, sax, eax = traverse_wide(wide, so, sd, t_max=tm, any_hit=True)
    assert np.mean(np.asarray(occ) != (np.asarray(sax) >= 0)) <= 1e-4
    assert int(ek) == int(ex) == int(eak) == int(eax) == 0


def test_kernel_edge_cases_match_xla_walk(gpu, rng):
    """Axis-parallel rays, per-ray t_max, inactive rays and flat ray lists
    on a small accel with empty child slots."""
    from tpurt.kernels.traverse import trace_any_cuda, trace_closest_cuda
    mesh = random_soup(90, seed=3)
    wide = _wide(mesh, leaf_size=4)
    n = 4096
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    d[: n // 4] = 0.0
    d[np.arange(n // 4), axis[: n // 4]] = rng.choice([-1.0, 1.0], n // 4)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(-1.0, 12.0, n).astype(np.float32)
    o, d, tmax = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)
    tk, sk, ek = trace_closest_cuda(wide, o, d, t_max=tmax)
    tx, sx, ex = traverse_wide(wide, o, d, t_max=tmax)
    sk, sx, tk, tx = (np.asarray(a) for a in (sk, sx, tk, tx))
    np.testing.assert_array_equal(sk >= 0, sx >= 0)
    np.testing.assert_allclose(tk, tx, rtol=1e-5)
    # The soup's triangles cross each other: a different triangle may win
    # only where both report the same t (a tie).
    tie = sk != sx
    assert tie.mean() <= 1e-3
    np.testing.assert_allclose(tk[tie], tx[tie], rtol=1e-6)
    occ, _ = trace_any_cuda(wide, o, d, tmax)
    _, sax, _ = traverse_wide(wide, o, d, t_max=tmax, any_hit=True)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(sax) >= 0)
    assert not np.asarray(occ)[np.asarray(tmax) <= 0].any()
    assert int(ek) == int(ex) == 0


def test_ffi_under_shard_map(gpu):
    """The FFI call inside shard_map(check_vma=True) over every visible
    card gives the unsharded result."""
    from tpurt.kernels.traverse import trace_any_cuda, trace_closest_cuda
    mesh = teapot_scene(5_000)
    wide = _wide(mesh)
    n_dev = len(jax.devices())
    o, d = generate_rays(default_camera_for(mesh), 256, 64 * n_dev)
    dev_mesh = jax.make_mesh((n_dev,), ("tiles",))

    def local(w, o, d):
        t, sidx, err = trace_closest_cuda(w, o, d)
        occ, err2 = trace_any_cuda(w, o, d, jnp.where(sidx >= 0, t, 0.0))
        return t, sidx, occ, jax.lax.psum(err + err2, "tiles")

    fn = jax.jit(jax.shard_map(
        local, mesh=dev_mesh, in_specs=(P(), P("tiles"), P("tiles")),
        out_specs=(P("tiles"), P("tiles"), P("tiles"), P()),
        check_vma=True))
    t, sidx, occ, err = fn(wide, o, d)
    t1, s1, e1 = trace_closest_cuda(wide, o, d)
    np.testing.assert_array_equal(np.asarray(sidx), np.asarray(s1))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t1))
    assert int(err) == int(e1) == 0
    assert not np.asarray(occ).any()   # t_max == the closest hit: no nearer


def test_kernel_frame_matches_plain_route(gpu):
    """A small Renderer frame: the kernel route against the XLA route."""
    from tpurt.app import Renderer
    from tpurt.types import Light, RenderConfig
    mesh = teapot_scene(3_000)
    cam = default_camera_for(mesh)
    lights = [Light.directional((0.45, 0.8, 0.3)),
              Light.sun((-0.5, 0.7, 0.2), angular_radius_deg=3.0)]
    imgs = []
    for use_kernel in (True, False):
        r = Renderer(mesh, cam, lights,
                     RenderConfig(width=160, height=120, spp=4,
                                  leaf_size=14, use_kernel=use_kernel))
        imgs.append(np.asarray(r.render_frame()["image"]))
    diff = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    assert (diff > 1e-3).mean() <= 1e-3


def test_kernel_stack_sized_from_tree(gpu):
    """A hand-made chain tree deeper than the 64-entry stack holds: the
    kernel instantiation size_stack picks walks it without errors and
    agrees with the XLA walk (tests/test_wide_walk.py builds the tree)."""
    from test_wide_walk import _chain_tree
    from tpurt.bvh.wide import size_stack
    from tpurt.kernels.traverse import trace_any_cuda, trace_closest_cuda
    wide = size_stack(_chain_tree(12))
    assert wide.stack_depth == 128
    o = jnp.zeros((4, 32, 3))
    d = jnp.broadcast_to(jnp.asarray([0.3, 0.5, 0.81]), (4, 32, 3))
    _, sk, ek = trace_closest_cuda(wide, o, d)
    occ, eak = trace_any_cuda(wide, o, d, 3.4e38)
    _, sx, ex = traverse_wide(wide, o, d)
    assert int(ek) == int(eak) == int(ex) == 0
    assert (np.asarray(sk) == -1).all() and (np.asarray(sx) == -1).all()
    assert not np.asarray(occ).any()
