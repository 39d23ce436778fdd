"""Shadow pass: per-pixel shadow rays from the G-buffer toward the light.

The equivalent of the reference's shadow dispatch
(Source/Shaders/RayTracedShadows.comp: one thread per pixel reads the
G-buffer position, offsets it along the normal, fires an any-hit ray toward
the directional light, writes a 0/1 mask [RECALL]). Extended per BASELINE
configs 3/5 with area-light (cone) soft shadows via jittered multi-sample
rays and point lights with finite t_max.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from ..camera import normalize
from ..types import (LIGHT_AREA_CONE, LIGHT_DIRECTIONAL, LIGHT_POINT, Light)


def _onb(n: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Branchless orthonormal basis around unit vector n (Duff et al. 2017)."""
    s = jnp.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t0 = jnp.concatenate([1.0 + s * n[..., 0:1] ** 2 * a, s * b,
                          -s * n[..., 0:1]], axis=-1)
    t1 = jnp.concatenate([b, s + n[..., 1:2] ** 2 * a, -n[..., 1:2]], axis=-1)
    return t0, t1


def sample_cone(d: jnp.ndarray, half_angle, u: jnp.ndarray) -> jnp.ndarray:
    """Uniform directions in a cone of the given half-angle around d.

    d: [..., 3] unit axis; u: [..., 2] uniforms in [0,1).
    """
    cos_t = 1.0 - u[..., 0] * (1.0 - jnp.cos(half_angle))
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * jnp.pi * u[..., 1]
    t0, t1 = _onb(d)
    return normalize(d * cos_t[..., None]
                     + t0 * (sin_t * jnp.cos(phi))[..., None]
                     + t1 * (sin_t * jnp.sin(phi))[..., None])


def scene_exit_t(origins: jnp.ndarray, dirs: jnp.ndarray,
                 bounds) -> jnp.ndarray:
    """Distance at which each ray exits the scene AABB (bmin, bmax).

    Used to cap directional shadow rays' t_max: no occluder exists outside
    the root box, so results are identical while the tighter per-lane cap
    prunes far nodes during traversal (measured win on Sponza interiors
    where many shadow rays exit through the ceiling quickly)."""
    bmin, bmax = bounds
    inv = jnp.clip(1.0 / dirs, -3.4e38, 3.4e38)
    t0 = (bmin - origins) * inv
    t1 = (bmax - origins) * inv
    exit_t = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return jnp.maximum(exit_t * (1.0 + 1e-4), 0.0)


def shadow_ray_batch(gbuf: Dict[str, jnp.ndarray], light: Light,
                     bias: float, u: jnp.ndarray | None,
                     scene_bounds=None
                     ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One shadow ray per pixel for one sample: (origins, dirs, t_max).

    u: [H, W, 2] uniforms for soft-shadow jitter, or None for the hard path.
    Invalid (sky) pixels get t_max = 0, so traversal exits on the root box
    test immediately — the masking the reference does by skipping invalid
    texels [RECALL]. scene_bounds: optional (root_min, root_max) to cap
    directional rays at the scene-AABB exit (see scene_exit_t).
    """
    pos = gbuf["position"]
    gn = gbuf["gnormal"]
    valid = gbuf["valid"]
    origins = pos + gn * bias

    if light.kind == LIGHT_POINT:
        delta = light.position - origins
        dist = jnp.sqrt(jnp.sum(delta * delta, axis=-1))
        dirs = delta / jnp.maximum(dist[..., None], 1e-12)
        if u is not None:
            # Jitter toward a disk of light.radius facing the shaded point
            # (radius 0 -> degenerate jitter == hard shadow).
            t0, t1 = _onb(dirs)
            r = jnp.sqrt(u[..., 0]) * light.radius
            phi = 2.0 * jnp.pi * u[..., 1]
            target = (light.position
                      + t0 * (r * jnp.cos(phi))[..., None]
                      + t1 * (r * jnp.sin(phi))[..., None])
            delta = target - origins
            dist = jnp.sqrt(jnp.sum(delta * delta, axis=-1))
            dirs = delta / jnp.maximum(dist[..., None], 1e-12)
        t_max = jnp.where(valid, dist * (1.0 - 1e-4), 0.0)
    else:
        d = jnp.broadcast_to(light.direction, origins.shape)
        if light.kind == LIGHT_AREA_CONE and u is not None:
            d = sample_cone(d, light.angular_radius, u)
        dirs = d
        far = scene_exit_t(origins, dirs, scene_bounds) \
            if scene_bounds is not None else jnp.float32(3.4e38)
        t_max = jnp.where(valid, far, 0.0)
    return origins, dirs, t_max


def shadow_pass(trace_any: Callable, gbuf: Dict[str, jnp.ndarray],
                light: Light, spp: int, key: jax.Array,
                bias: float, scene_bounds=None):
    """Shadow visibility in [0, 1] per pixel (1 = fully lit) and the walk
    error count: (f32[H, W], i32[]).

    trace_any(origins, dirs, t_max) -> (occluded bool[...], errors). Soft
    lights (area-cone, or point with a radius, at spp > 1) trace spp
    jittered samples in a lax.scan — ONE traversal lowering regardless of
    spp, and live memory stays one ray-grid (SURVEY.md §5 long-axis
    blocking).
    """
    soft = light.kind in (LIGHT_AREA_CONE, LIGHT_POINT) and spp > 1
    h, w = gbuf["valid"].shape
    if not soft:
        origins, dirs, t_max = shadow_ray_batch(gbuf, light, bias, None,
                                                scene_bounds=scene_bounds)
        occluded, errors = trace_any(origins, dirs, t_max)
        vis = jnp.where(gbuf["valid"], jnp.where(occluded, 0.0, 1.0), 1.0)
        return vis, errors

    def sample(carry, s):
        acc, errors = carry
        u = jax.random.uniform(jax.random.fold_in(key, s), (h, w, 2))
        origins, dirs, t_max = shadow_ray_batch(gbuf, light, bias, u,
                                                scene_bounds=scene_bounds)
        occluded, err = trace_any(origins, dirs, t_max)
        return (acc + jnp.where(occluded, 0.0, 1.0), errors + err), None

    # Carry inits derive from the G-buffer so they vary over shard_map
    # axes exactly like the per-sample results do.
    zero = jnp.where(gbuf["valid"], 0.0, 0.0)
    (acc, errors), _ = jax.lax.scan(
        sample, (zero, jnp.sum(zero).astype(jnp.int32)), jnp.arange(spp))
    return jnp.where(gbuf["valid"], acc / spp, 1.0), errors
