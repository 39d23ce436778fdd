"""G-buffer pass: primary visibility as a batched ray cast.

Replaces the reference's raster G-buffer (Model.vert/Model.frag writing world
position, normal, albedo, depth [RECALL]) with a closest-hit ray cast through
the same BVH (BASELINE.json: "primary visibility ... run as batched JAX
passes"), reusing the traversal instead of emulating a rasterizer.

Outputs a dict of image-shaped arrays:
  position f32[H,W,3], normal f32[H,W,3] (smooth), gnormal f32[H,W,3]
  (geometric, for shadow bias), albedo f32[H,W,3], depth f32[H,W],
  t f32[H,W], tri_id i32[H,W], valid bool[H,W], trace_errors i32[]
"""

from __future__ import annotations

from typing import Callable, Dict

import jax.numpy as jnp

from ..camera import generate_rays, normalize, view_depth
from ..types import Camera, Mesh


def shade_attributes(mesh: Mesh, tri_id: jnp.ndarray, position: jnp.ndarray,
                     valid: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """Interpolated vertex attributes at hit points.

    Barycentrics are recomputed from the hit position against the hit
    triangle (one gather per pixel — cheaper than carrying u/v through the
    traversal kernels).
    """
    from .shading import barycentrics_from_position
    tid = jnp.maximum(tri_id, 0)
    tri = mesh.indices[tid]                       # [..., 3]
    v0 = mesh.vertices[tri[..., 0]]
    v1 = mesh.vertices[tri[..., 1]]
    v2 = mesh.vertices[tri[..., 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    u, v = barycentrics_from_position(v0, e1, e2, position)

    n0 = mesh.normals[tri[..., 0]]
    n1 = mesh.normals[tri[..., 1]]
    n2 = mesh.normals[tri[..., 2]]
    smooth = normalize(n0 + u[..., None] * (n1 - n0) + v[..., None] * (n2 - n0))
    gnormal = normalize(jnp.cross(e1, e2))
    albedo = mesh.albedo[tid]
    zeros = jnp.zeros_like(smooth)
    vmask = valid[..., None]
    return {
        "normal": jnp.where(vmask, smooth, zeros),
        "gnormal": jnp.where(vmask, gnormal, zeros),
        "albedo": jnp.where(vmask, albedo, zeros),
    }


def gbuffer_pass(trace_closest: Callable, mesh: Mesh, cam: Camera,
                 width: int, height: int,
                 jitter: jnp.ndarray | None = None,
                 shade_table: jnp.ndarray | None = None,
                 rays=None) -> Dict[str, jnp.ndarray]:
    """trace_closest(origins, dirs) -> (t, tri_id | None, sorted_idx | None,
    errors) (app.make_tracers); injected so the same pass runs on every
    traversal route.

    Walks of the 8-wide accel return the sorted hit index and no tri_id:
    the packed ``shade_table`` (passes/shading.py) then supplies every
    shading attribute, tri_id included, in ONE per-pixel row gather. Walks
    of the binary LBVH return the original tri_id, and attributes are
    gathered from the mesh.

    rays: optional precomputed (origins, dirs) — the sharded path passes
    its row-shard here instead of generating the full frame. The result
    carries the tracer's walk-error count as ``trace_errors``."""
    if rays is None:
        origins, dirs = generate_rays(cam, width, height, jitter)
    else:
        origins, dirs = rays
    t, tri_id, sorted_idx, errors = trace_closest(origins, dirs)
    valid = (sorted_idx >= 0) if tri_id is None else (tri_id >= 0)
    t_safe = jnp.where(valid, t, 0.0)
    position = origins + dirs * t_safe[..., None]
    extra = {}
    if sorted_idx is not None:
        if shade_table is None:
            raise ValueError("a sorted-index tracer needs the shade table "
                             "of its accel's LBVH")
        from .shading import shade_from_table, table_tri_id, table_uv
        rows = shade_table[jnp.clip(sorted_idx, 0,
                                    shade_table.shape[0] - 1)]
        attrs = shade_from_table(rows, position, valid)
        tri_id = table_tri_id(rows, valid)
        if mesh.textured:
            uv, layer = table_uv(rows, attrs["u"], attrs["v"])
            extra = {"uv": uv, "tex_layer": jnp.where(valid, layer, -1)}
    else:
        attrs = shade_attributes(mesh, tri_id, position, valid)
    # Offset-ready geometric normal: flip toward the viewer so the shadow
    # bias pushes off the visible side (reference applies a normal-offset
    # bias before tracing [RECALL]).
    facing = jnp.sign(-jnp.sum(attrs["gnormal"] * dirs, axis=-1, keepdims=True))
    gnormal = attrs["gnormal"] * jnp.where(facing == 0, 1.0, facing)
    smooth = attrs["normal"] * jnp.where(facing == 0, 1.0, facing)
    return {
        "position": position,
        "normal": smooth,
        "gnormal": gnormal,
        "albedo": attrs["albedo"],
        "depth": view_depth(cam, position, valid),
        "t": t,
        "tri_id": tri_id,
        "valid": valid,
        "view_dir": dirs,
        "trace_errors": errors,
        **extra,
    }
