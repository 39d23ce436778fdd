"""Stage-1 tests: core types, camera rays, scenes, OBJ + PNG round-trips."""

import os

import jax
import numpy as np
import pytest

from tpurt import Camera, Light, Mesh, RenderConfig
from tpurt.camera import camera_basis, generate_rays
from tpurt.io.image import read_png, write_png
from tpurt.io.obj import load_obj, save_obj
from tpurt.scenes import (compute_smooth_normals, make_box, make_plane,
                          make_sphere, make_torus, merge_meshes, random_soup,
                          sponza_scene, teapot_scene)


def test_mesh_pytree_roundtrip():
    m = make_box((0, 0, 0), (1, 1, 1))
    leaves, treedef = jax.tree_util.tree_flatten(m)
    m2 = jax.tree_util.tree_unflatten(treedef, leaves)
    np.testing.assert_array_equal(m.vertices, m2.vertices)
    np.testing.assert_array_equal(m.indices, m2.indices)


def test_light_pytree_keeps_kind_static():
    l = Light.sun((1, 2, 3), angular_radius_deg=1.0)
    leaves, treedef = jax.tree_util.tree_flatten(l)
    l2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert l2.kind == l.kind
    np.testing.assert_allclose(np.linalg.norm(l.direction), 1.0, rtol=1e-6)


def test_camera_basis_orthonormal():
    cam = Camera.look_at((3, 4, 5), (0, 0, 0))
    r, u, f = (np.asarray(x) for x in camera_basis(cam))
    for a in (r, u, f):
        np.testing.assert_allclose(np.linalg.norm(a), 1.0, atol=1e-5)
    assert abs(np.dot(r, u)) < 1e-5
    assert abs(np.dot(r, f)) < 1e-5
    assert abs(np.dot(u, f)) < 1e-5
    # forward points at the target
    want = -np.asarray(cam.position) / np.linalg.norm(cam.position)
    np.testing.assert_allclose(f, want, atol=1e-5)


def test_generate_rays_shapes_and_center():
    cam = Camera.look_at((0, 0, 5), (0, 0, 0), fov_y_deg=90.0)
    o, d = generate_rays(cam, 64, 32)
    assert o.shape == (32, 64, 3) and d.shape == (32, 64, 3)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-5)
    # center pixel looks straight at the target
    cd = np.asarray(d)[16, 32]
    np.testing.assert_allclose(cd, [0, 0, -1], atol=0.05)
    # top-left pixel should look up-left (negative x, positive y)
    tl = np.asarray(d)[0, 0]
    assert tl[0] < 0 and tl[1] > 0


def test_smooth_normals_flat_plane():
    m = make_plane(subdiv=3)
    n = compute_smooth_normals(np.asarray(m.vertices), np.asarray(m.indices))
    np.testing.assert_allclose(n, np.tile([0, 1, 0], (len(n), 1)), atol=1e-6)


def test_scene_generators_sane():
    tea = teapot_scene()
    assert 6_000 <= tea.num_triangles <= 20_000
    spz = sponza_scene()
    assert 180_000 <= spz.num_triangles <= 350_000
    for m in (tea, spz):
        assert np.asarray(m.indices).max() < m.num_vertices
        assert np.isfinite(np.asarray(m.vertices)).all()
        assert m.albedo.shape == (m.num_triangles, 3)


def test_merge_meshes_offsets():
    a = make_box((0, 0, 0), (1, 1, 1))
    b = make_sphere(rows=4, cols=8)
    m = merge_meshes([a, b])
    assert m.num_triangles == a.num_triangles + b.num_triangles
    assert np.asarray(m.indices).max() == m.num_vertices - 1


def test_obj_roundtrip(tmp_path):
    m = make_torus(seg_u=8, seg_v=6)
    p = os.path.join(tmp_path, "t.obj")
    save_obj(p, m)
    m2 = load_obj(p)
    assert m2.num_triangles == m.num_triangles
    # same vertex positions up to dedup/reorder: compare sorted coordinates
    a = np.sort(np.round(np.asarray(m.vertices), 5), axis=0)
    b = np.sort(np.round(np.asarray(m2.vertices), 5), axis=0)
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_obj_parses_polygons_and_negative_indices(tmp_path):
    src = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f -4 -3 -2 -1
"""
    p = os.path.join(tmp_path, "quad.obj")
    with open(p, "w") as f:
        f.write(src)
    m = load_obj(p)
    assert m.num_triangles == 2  # fan triangulated
    assert m.num_vertices == 4


def test_png_roundtrip(tmp_path):
    img = (np.random.default_rng(0).uniform(0, 255, (17, 23, 3))).astype(np.uint8)
    p = os.path.join(tmp_path, "x.png")
    write_png(p, img)
    back = read_png(p)
    np.testing.assert_array_equal(img, back)


def test_render_config_static_hashable():
    c = RenderConfig(width=64, height=32)
    assert hash(c) == hash(RenderConfig(width=64, height=32))
    assert c.num_pixels == 64 * 32
    assert c.use_kernel and c.bvh_width == 8
    assert hash(c) != hash(RenderConfig(width=64, height=32,
                                        use_kernel=False))


def test_camera_orbit():
    """orbit() rotates the eye around the up axis through the target:
    distance and elevation are preserved, a full circle returns home, and
    the target/fov are untouched (the CLI --orbit flythrough path)."""
    import numpy as np
    from tpurt.camera import orbit
    from tpurt.types import Camera
    cam = Camera.look_at((3.0, 2.0, 0.0), (1.0, 0.5, -0.5))
    r0 = np.asarray(cam.position) - np.asarray(cam.target)
    c = cam
    for _ in range(5):
        c = orbit(c, 2.0 * np.pi / 5.0)
        r = np.asarray(c.position) - np.asarray(c.target)
        assert abs(np.linalg.norm(r) - np.linalg.norm(r0)) < 1e-5
        up = np.asarray(cam.up, np.float64)
        up /= np.linalg.norm(up)
        assert abs(np.dot(r, up) - np.dot(r0, up)) < 1e-5   # elevation
    assert np.abs(np.asarray(c.position) - np.asarray(cam.position)).max() \
        < 1e-5
    np.testing.assert_array_equal(np.asarray(c.target),
                                  np.asarray(cam.target))
