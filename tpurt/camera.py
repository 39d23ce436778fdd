"""Camera ray generation and view/projection math.

The replacement for the reference's vertex-shader rasterization setup
(Model.vert view/proj matrices + Rush CameraManipulator [RECALL]): instead of
rasterizing, the G-buffer pass casts one primary ray per pixel, so the camera's
job here is to produce a batched ray grid as arrays.

All functions are jit-safe (pure jnp, static shapes).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .types import Camera


def normalize(v, axis=-1, eps=1e-20):
    return v / jnp.sqrt(jnp.sum(v * v, axis=axis, keepdims=True) + eps)


def camera_basis(cam: Camera) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Right-handed orthonormal basis (right, up, forward).

    forward points from eye toward target.
    """
    forward = normalize(cam.target - cam.position)
    right = normalize(jnp.cross(forward, cam.up))
    up = jnp.cross(right, forward)
    return right, up, forward


def generate_rays(cam: Camera, width: int, height: int,
                  jitter: jnp.ndarray | None = None
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Primary rays through every pixel center.

    Returns (origins f32[H, W, 3], directions f32[H, W, 3]); directions are
    unit length. Pixel (0, 0) is the top-left corner, matching image layout.

    jitter: optional f32[H, W, 2] sub-pixel offsets in [0, 1) (anti-aliasing);
    defaults to pixel centers (0.5, 0.5).
    """
    right, up, forward = camera_basis(cam)
    aspect = width / height
    tan_half = jnp.tan(cam.fov_y * 0.5)

    yy = jnp.arange(height, dtype=jnp.float32)[:, None]
    xx = jnp.arange(width, dtype=jnp.float32)[None, :]
    if jitter is None:
        jx = jy = 0.5
    else:
        jx = jitter[..., 0]
        jy = jitter[..., 1]
    # NDC in [-1, 1]; +y up in camera space -> flip image y.
    ndc_x = ((xx + jx) / width) * 2.0 - 1.0
    ndc_y = 1.0 - ((yy + jy) / height) * 2.0
    ndc_x = jnp.broadcast_to(ndc_x, (height, width))
    ndc_y = jnp.broadcast_to(ndc_y, (height, width))

    d = (ndc_x[..., None] * (tan_half * aspect) * right
         + ndc_y[..., None] * tan_half * up
         + forward)
    directions = normalize(d)
    origins = jnp.broadcast_to(cam.position, (height, width, 3))
    return origins.astype(jnp.float32), directions.astype(jnp.float32)


@partial(jax.jit, static_argnums=(1, 2))
def camera_rays(cam: Camera, width: int, height: int
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """generate_rays at pixel centers as a program of its own. The Renderer
    and the sharded frame (parallel/tiling.py) both take their primary rays
    from it, so a camera gives bit-identical rays on any number of devices:
    the same math compiled into two different programs may round
    differently and flip pixels on triangle edges."""
    return generate_rays(cam, width, height)


def view_depth(cam: Camera, positions: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Camera-space depth (distance along forward axis) for G-buffer depth.

    Matches the reference G-buffer's depth target semantics (Model.frag writes
    depth [RECALL]); invalid (sky) pixels get zfar.
    """
    _, _, forward = camera_basis(cam)
    d = jnp.einsum("...k,k->...", positions - cam.position, forward)
    return jnp.where(valid, d, cam.zfar).astype(jnp.float32)


def orbit(cam: Camera, angle) -> Camera:
    """Eye rotated by ``angle`` radians around the camera's up axis through
    the target — the headless analogue of the reference's interactive fly
    camera (Rush CameraManipulator mouse-look [RECALL]): a deterministic
    per-frame camera path for flythrough sequences (CLI --orbit).
    jit-safe; target/up/fov are preserved."""
    import dataclasses
    u = normalize(jnp.asarray(cam.up, jnp.float32), axis=0)
    r = jnp.asarray(cam.position, jnp.float32) \
        - jnp.asarray(cam.target, jnp.float32)
    c, s = jnp.cos(angle), jnp.sin(angle)
    # Rodrigues rotation of the eye offset about u.
    r_rot = (r * c + jnp.cross(u, r) * s
             + u * jnp.dot(u, r) * (1.0 - c))
    return dataclasses.replace(cam, position=(cam.target + r_rot))
