"""Diffuse texture sampling (passes/texture.py) + textured OBJ loading.

The reference samples diffuse textures for albedo (Model.frag [RECALL]);
these tests pin the rebuilt capability: atlas sampling semantics, UV
interpolation, loader map_Kd handling (both parsers), and an end-to-end
textured render through every G-buffer path's shared post-pass.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.passes.texture import apply_textures, interpolate_uv, sample_atlas
from tpurt.types import Light, Mesh, RenderConfig


def _quad_mesh(atlas=None):
    """Unit quad in the XY plane (two triangles), uv spanning [0,1]^2."""
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    n = np.tile(np.float32([0, 0, 1]), (4, 1))
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = v[:, :2].astype(np.float32)
    albedo = np.tile(np.float32([0.5, 0.5, 0.5]), (2, 1))
    tri_tex = np.zeros(2, np.int32) if atlas is not None else None
    return Mesh(vertices=v, normals=n, indices=idx, albedo=albedo,
                uv=uv if atlas is not None else None, tex_atlas=atlas,
                tri_tex=tri_tex)


def _checker(res=8, c0=(1, 0, 0), c1=(0, 0, 1), cell=1):
    """Checkerboard texture; cell = texels per checker square (cell > 1
    keeps most BILINEAR samples pure — a per-texel checker is mid-gray
    almost everywhere under bilinear filtering)."""
    y, x = np.mgrid[0:res, 0:res]
    m = ((x // cell + y // cell) % 2 == 0)[..., None]
    return np.where(m, np.float32(c0), np.float32(c1)).astype(np.float32)


def test_sample_atlas_nearest_exact():
    atlas = jnp.asarray(_checker(4)[None])
    # texel centers: uv = (x + 0.5)/R
    uv = jnp.asarray([[(0.5) / 4, (0.5) / 4],
                      [(1.5) / 4, (0.5) / 4]])
    got = np.asarray(sample_atlas(atlas, jnp.zeros(2, jnp.int32), uv,
                                  bilinear=False))
    np.testing.assert_allclose(got[0], [1, 0, 0])
    np.testing.assert_allclose(got[1], [0, 0, 1])


def test_sample_atlas_bilinear_midpoint():
    atlas = jnp.zeros((1, 4, 4, 3), jnp.float32)
    atlas = atlas.at[0, 0, 0].set(jnp.asarray([1.0, 0.0, 0.0]))
    atlas = atlas.at[0, 0, 1].set(jnp.asarray([0.0, 1.0, 0.0]))
    uv = jnp.asarray([[1.0 / 4, 0.5 / 4]])    # midway between texels 0,1
    got = np.asarray(sample_atlas(atlas, jnp.zeros(1, jnp.int32), uv))
    np.testing.assert_allclose(got[0], [0.5, 0.5, 0.0], atol=1e-6)


def test_sample_atlas_wraps():
    atlas = jnp.asarray(_checker(4)[None])
    base = jnp.asarray([[0.5 / 4, 0.5 / 4]])
    got0 = np.asarray(sample_atlas(atlas, jnp.zeros(1, jnp.int32), base))
    got1 = np.asarray(sample_atlas(atlas, jnp.zeros(1, jnp.int32),
                                   base + 1.0))
    got2 = np.asarray(sample_atlas(atlas, jnp.zeros(1, jnp.int32),
                                   base - 2.0))
    np.testing.assert_allclose(got0, got1, atol=1e-6)
    np.testing.assert_allclose(got0, got2, atol=1e-5)


def test_sample_atlas_layers():
    atlas = jnp.stack([jnp.full((4, 4, 3), 0.25, jnp.float32),
                       jnp.full((4, 4, 3), 0.75, jnp.float32)])
    uv = jnp.asarray([[0.4, 0.6], [0.4, 0.6]])
    got = np.asarray(sample_atlas(atlas, jnp.asarray([0, 1]), uv))
    np.testing.assert_allclose(got[0], [0.25] * 3, atol=1e-6)
    np.testing.assert_allclose(got[1], [0.75] * 3, atol=1e-6)


def test_interpolate_uv_quad_center():
    mesh = _quad_mesh(atlas=np.zeros((1, 4, 4, 3), np.float32))
    pos = jnp.asarray([[0.25, 0.25, 0.0], [0.75, 0.25, 0.0]])
    uv = np.asarray(interpolate_uv(mesh, jnp.asarray([0, 0]), pos))
    np.testing.assert_allclose(uv, [[0.25, 0.25], [0.75, 0.25]], atol=1e-5)


def test_apply_textures_respects_untextured_triangles():
    atlas = _checker(8)[None]
    mesh = _quad_mesh(atlas=atlas)
    mesh = Mesh(vertices=mesh.vertices, normals=mesh.normals,
                indices=mesh.indices, albedo=mesh.albedo, uv=mesh.uv,
                tex_atlas=jnp.asarray(atlas),
                tri_tex=jnp.asarray([0, -1], jnp.int32))  # tri 1 flat
    gbuf = {
        "tri_id": jnp.asarray([0, 1]),
        "position": jnp.asarray([[0.9, 0.05, 0.0], [0.1, 0.9, 0.0]]),
        "valid": jnp.asarray([True, True]),
        "albedo": jnp.full((2, 3), 0.5, jnp.float32),
    }
    out = np.asarray(apply_textures(mesh, gbuf))
    assert not np.allclose(out[0], 0.5)     # textured triangle sampled
    np.testing.assert_allclose(out[1], 0.5)  # flat triangle untouched


def test_textured_render_end_to_end():
    """Full Renderer frame on a textured quad: the checker must show up in
    the G-buffer albedo (and differ from the flat-albedo twin)."""
    from tpurt.app import Renderer
    from tpurt.types import Camera
    atlas = _checker(32, c0=(1, 1, 1), c1=(0, 0, 0), cell=8)[None]
    mesh = _quad_mesh(atlas=atlas)
    cam = Camera.look_at((0.5, 0.5, 2.0), (0.5, 0.5, 0.0),
                         fov_y_deg=40.0, znear=0.01, zfar=10.0)
    light = Light.directional((0.2, 0.3, 1.0))
    cfg = RenderConfig(width=64, height=64, use_kernel=False, leaf_size=4)
    out = Renderer(mesh, cam, light, cfg).render_frame()
    alb = np.asarray(out["albedo"])
    valid = np.asarray(out["valid"])
    assert valid.sum() > 500
    vals = alb[valid][:, 0]
    # checker: a healthy mix of dark and bright samples
    assert (vals > 0.7).mean() > 0.2
    assert (vals < 0.3).mean() > 0.2
    flat = Renderer(_quad_mesh(), cam, light, cfg).render_frame()
    assert not np.allclose(np.asarray(flat["albedo"])[valid], alb[valid])


@pytest.mark.parametrize("use_native", [False, True])
def test_obj_loader_map_kd(tmp_path, use_native):
    """OBJ + MTL + map_Kd PNG round-trip through BOTH parsers: the mesh
    carries uv/atlas/layers and both loaders agree."""
    from tpurt.io.image import write_png
    from tpurt.io.obj import load_obj
    from tpurt import native
    if use_native and not native.available():
        pytest.skip("native lib unavailable")
    tex = _checker(8)
    write_png(str(tmp_path / "checker.png"), tex, gamma=False)
    (tmp_path / "scene.mtl").write_text(
        "newmtl mat0\nKd 0.9 0.2 0.1\nmap_Kd checker.png\n"
        "newmtl flat\nKd 0.2 0.9 0.2\n")
    (tmp_path / "scene.obj").write_text(
        "mtllib scene.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl mat0\nf 1/1 2/2 3/3\n"
        "usemtl flat\nf 1/1 3/3 4/4\n")
    mesh = load_obj(str(tmp_path / "scene.obj"), use_native=use_native)
    assert mesh.textured
    assert mesh.tex_atlas.shape[0] == 1
    assert mesh.uv.shape[0] == mesh.vertices.shape[0]
    tt = np.asarray(mesh.tri_tex)
    assert tt.tolist() == [0, -1]
    np.testing.assert_allclose(np.asarray(mesh.albedo)[1], [0.2, 0.9, 0.2])
    # parser equivalence
    other = load_obj(str(tmp_path / "scene.obj"),
                     use_native=not use_native) if native.available() \
        else None
    if other is not None:
        assert other.num_vertices == mesh.num_vertices
        np.testing.assert_allclose(np.asarray(other.uv),
                                   np.asarray(mesh.uv), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(other.tri_tex), tt)
