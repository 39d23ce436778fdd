"""Diffuse texture sampling (opt-in capability parity with the reference).

The reference's fragment shader samples a diffuse texture for albedo
(Model.frag [RECALL; mount empty at survey time]); the rebuild's default
path keeps per-triangle flat albedo (texture-free Sponza stand-in — no
real assets are obtainable offline), and this pass adds real sampling for
meshes that carry textures.

Design: all textures live in ONE stacked square atlas f32[NT, R, R, 3]
so a sample is a computed flat index into a single array — one gather per
tap, identical cost for every texture, no ragged shapes. Sampling runs as
a G-buffer post-pass on (tri_id, position), so every traversal route gets
textures through the same code path.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..types import Mesh


def sample_atlas(atlas: jnp.ndarray, layer: jnp.ndarray, uv: jnp.ndarray,
                 bilinear: bool = True) -> jnp.ndarray:
    """Sample the texture atlas with REPEAT wrapping.

    atlas: f32[NT, R, R, 3]; layer: i32[...]; uv: f32[..., 2] in texture
    space ((0,0) = first texel row/col; rows index uv[1]). Returns
    f32[..., 3].
    """
    nt, r = atlas.shape[0], atlas.shape[1]
    flat = atlas.reshape(-1, 3)
    u = uv[..., 0] * r - 0.5
    v = uv[..., 1] * r - 0.5
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    lay = jnp.clip(layer, 0, nt - 1)

    def tap(xi, yi):
        xi = jnp.mod(xi, r)
        yi = jnp.mod(yi, r)
        return flat[(lay * r + yi) * r + xi]

    if not bilinear:
        return tap(x0 + (fx[..., 0] >= 0.5), y0 + (fy[..., 0] >= 0.5)
                   ).astype(jnp.float32)
    c00 = tap(x0, y0)
    c10 = tap(x0 + 1, y0)
    c01 = tap(x0, y0 + 1)
    c11 = tap(x0 + 1, y0 + 1)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def interpolate_uv(mesh: Mesh, tri_id: jnp.ndarray,
                   position: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel texture coordinates at hit points: barycentrics are
    recomputed from the hit position against the hit triangle (same
    normal-equations solve as gbuffer.shade_attributes)."""
    from .shading import barycentrics_from_position
    tid = jnp.maximum(tri_id, 0)
    tri = mesh.indices[tid]
    v0 = mesh.vertices[tri[..., 0]]
    e1 = mesh.vertices[tri[..., 1]] - v0
    e2 = mesh.vertices[tri[..., 2]] - v0
    u, v = barycentrics_from_position(v0, e1, e2, position)
    uv0 = mesh.uv[tri[..., 0]]
    uv1 = mesh.uv[tri[..., 1]]
    uv2 = mesh.uv[tri[..., 2]]
    return uv0 + u[..., None] * (uv1 - uv0) + v[..., None] * (uv2 - uv0)


def apply_textures(mesh: Mesh, gbuf: dict, bilinear: bool = True
                   ) -> jnp.ndarray:
    """Textured albedo for a G-buffer: samples the atlas where the hit
    triangle has a texture layer, keeps the flat per-triangle albedo
    elsewhere. Works on any G-buffer that carries (tri_id, position,
    valid, albedo)."""
    if "uv" in gbuf and "tex_layer" in gbuf:
        # The shade-table G-buffer already interpolated uv and carried the
        # layer in its packed row — skip the per-pixel vertex/uv gathers.
        uv = gbuf["uv"]
        layer = gbuf["tex_layer"]
    else:
        tri_id = gbuf["tri_id"]
        tid = jnp.maximum(tri_id, 0)
        layer = mesh.tri_tex[tid]
        uv = interpolate_uv(mesh, tri_id, gbuf["position"])
    tex = sample_atlas(mesh.tex_atlas, layer, uv, bilinear=bilinear)
    use_tex = (layer >= 0) & gbuf["valid"]
    return jnp.where(use_tex[..., None], tex, gbuf["albedo"])
