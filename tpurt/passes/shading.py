"""Packed per-triangle shading table: one gather instead of eight.

The naive G-buffer attribute fetch needs ~8 per-pixel gathers (triangle
indices, three vertices, three vertex normals, albedo). This module packs
everything shading needs into ONE f32[Tpad, 24] row per (sorted) triangle:

    [v0.xyz, e1.xyz, e2.xyz, oct(n0), oct(n1), oct(n2), albedo_u8x3,
     tri_id, uv0, uv1, uv2, texture layer]

so the whole fetch is a single gather keyed by the traversal's sorted hit
index (spatially coherent across the image). Vertex normals are
octahedral-encoded (2 floats, ~1e-3 angular error — shading-grade, never
used for geometry); albedo rides as three 8-bit channels packed exactly into
one float.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..bvh.lbvh import LBVH
from ..camera import normalize
from ..types import Mesh


def oct_encode(n: jnp.ndarray) -> jnp.ndarray:
    """Unit vectors [..., 3] -> octahedral [..., 2] in [-1, 1]."""
    s = jnp.sum(jnp.abs(n), axis=-1, keepdims=True)
    p = n[..., :2] / jnp.maximum(s, 1e-20)
    x, y = p[..., 0], p[..., 1]
    wrap_x = (1.0 - jnp.abs(y)) * jnp.where(x >= 0, 1.0, -1.0)
    wrap_y = (1.0 - jnp.abs(x)) * jnp.where(y >= 0, 1.0, -1.0)
    neg = n[..., 2] < 0
    return jnp.stack([jnp.where(neg, wrap_x, x),
                      jnp.where(neg, wrap_y, y)], axis=-1)


def oct_decode(e: jnp.ndarray) -> jnp.ndarray:
    """Octahedral [..., 2] -> unit vectors [..., 3]."""
    x, y = e[..., 0], e[..., 1]
    z = 1.0 - jnp.abs(x) - jnp.abs(y)
    neg = z < 0
    xf = jnp.where(neg, (1.0 - jnp.abs(y)) * jnp.where(x >= 0, 1.0, -1.0), x)
    yf = jnp.where(neg, (1.0 - jnp.abs(x)) * jnp.where(y >= 0, 1.0, -1.0), y)
    return normalize(jnp.stack([xf, yf, z], axis=-1))


def pack_rgb(albedo: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] in [0,1] -> one float holding three exact 8-bit channels."""
    q = jnp.clip(jnp.round(albedo * 255.0), 0, 255)
    return q[..., 0] * 65536.0 + q[..., 1] * 256.0 + q[..., 2]


def unpack_rgb(f: jnp.ndarray) -> jnp.ndarray:
    r = jnp.floor(f / 65536.0)
    g = jnp.floor((f - r * 65536.0) / 256.0)
    b = f - r * 65536.0 - g * 256.0
    return jnp.stack([r, g, b], axis=-1) / 255.0


def smooth_normals_device(vertices: jnp.ndarray,
                          indices: jnp.ndarray) -> jnp.ndarray:
    """Area-weighted vertex normals fully on device (scatter-add of face
    normals) — the animated-mesh path recomputes these per frame; the host
    NumPy version in scenes.py is for load time."""
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    fn = jnp.cross(vertices[i1] - vertices[i0], vertices[i2] - vertices[i0])
    n = jnp.zeros_like(vertices)
    n = n.at[i0].add(fn).at[i1].add(fn).at[i2].add(fn)
    return normalize(n)


def make_shade_table(bvh: LBVH, mesh: Mesh) -> jnp.ndarray:
    """f32[Tpad, 24] shading rows in Morton-sorted triangle order.

    Built once per (re)build with T-sized gathers (cheap relative to the
    per-pixel gathers it replaces). Layout:

        [0:9]   v0.xyz, e1.xyz, e2.xyz
        [9:15]  oct(n0), oct(n1), oct(n2)
        [15]    albedo as packed 8-bit rgb
        [16]    ORIGINAL triangle id (int32 bit pattern) — riding in
                the shading row, it needs no gather of its own
        [17:23] uv0, uv1, uv2 (textured meshes; zeros otherwise)
        [23]    texture layer as a float (-1 = untextured triangle)
    """
    tri = mesh.indices[bvh.tri_id]            # [Tpad, 3]
    n0 = oct_encode(mesh.normals[tri[:, 0]])
    n1 = oct_encode(mesh.normals[tri[:, 1]])
    n2 = oct_encode(mesh.normals[tri[:, 2]])
    alb = pack_rgb(mesh.albedo[bvh.tri_id])[:, None]
    tid = jax.lax.bitcast_convert_type(bvh.tri_id.astype(jnp.int32),
                                       jnp.float32)[:, None]
    if mesh.textured:
        uv = jnp.concatenate([mesh.uv[tri[:, 0]], mesh.uv[tri[:, 1]],
                              mesh.uv[tri[:, 2]]], axis=1)
        layer = mesh.tri_tex[bvh.tri_id].astype(jnp.float32)[:, None]
    else:
        uv = jnp.zeros((tri.shape[0], 6), jnp.float32)
        layer = jnp.full((tri.shape[0], 1), -1.0, jnp.float32)
    return jnp.concatenate(
        [bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, n0, n1, n2, alb, tid, uv,
         layer], axis=1).astype(jnp.float32)


def table_tri_id(rows: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Original triangle ids out of gathered rows (lane 16); -1 invalid."""
    tid = jax.lax.bitcast_convert_type(rows[..., 16], jnp.int32)
    return jnp.where(valid, tid, -1)


def table_uv(rows: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Interpolated texture coords + layer out of gathered rows."""
    uv0 = rows[..., 17:19]
    uv1 = rows[..., 19:21]
    uv2 = rows[..., 21:23]
    uv = uv0 + u[..., None] * (uv1 - uv0) + v[..., None] * (uv2 - uv0)
    return uv, rows[..., 23].astype(jnp.int32)


def barycentrics_from_position(v0: jnp.ndarray, e1: jnp.ndarray,
                               e2: jnp.ndarray, position: jnp.ndarray):
    """(u, v) of ``position`` against triangle (v0, e1, e2), clipped to the
    triangle: the 2x2 normal-equations solve of p - v0 = u*e1 + v*e2 in
    the triangle plane. THE shared solve — gbuffer.shade_attributes,
    shade_from_table, and texture.interpolate_uv all interpolate with it,
    so epsilon/clamping fixes apply to every consumer at once."""
    w = position - v0
    d11 = jnp.sum(e1 * e1, axis=-1)
    d12 = jnp.sum(e1 * e2, axis=-1)
    d22 = jnp.sum(e2 * e2, axis=-1)
    dw1 = jnp.sum(w * e1, axis=-1)
    dw2 = jnp.sum(w * e2, axis=-1)
    det = jnp.maximum(d11 * d22 - d12 * d12, 1e-20)
    u = jnp.clip((d22 * dw1 - d12 * dw2) / det, 0.0, 1.0)
    v = jnp.clip((d11 * dw2 - d12 * dw1) / det, 0.0, 1.0)
    return u, v


def shade_from_table(rows: jnp.ndarray, position: jnp.ndarray,
                     valid: jnp.ndarray):
    """Gathered table rows [..., 16] + hit positions -> attribute dict
    (same contract as passes.gbuffer.shade_attributes)."""
    v0 = rows[..., 0:3]
    e1 = rows[..., 3:6]
    e2 = rows[..., 6:9]
    u, v = barycentrics_from_position(v0, e1, e2, position)
    n0 = oct_decode(rows[..., 9:11])
    n1 = oct_decode(rows[..., 11:13])
    n2 = oct_decode(rows[..., 13:15])
    smooth = normalize(n0 + u[..., None] * (n1 - n0) + v[..., None] * (n2 - n0))
    gnormal = normalize(jnp.cross(e1, e2))
    albedo = unpack_rgb(rows[..., 15])
    zeros = jnp.zeros_like(smooth)
    vmask = valid[..., None]
    return {
        "normal": jnp.where(vmask, smooth, zeros),
        "gnormal": jnp.where(vmask, gnormal, zeros),
        "albedo": jnp.where(vmask, albedo, zeros),
        "u": u,
        "v": v,
    }
