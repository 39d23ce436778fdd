"""Multi-chip scaling: pixel-tile data parallelism over a device mesh.

The reference is single-GPU; its only parallelism is SIMT threads in a
dispatch (SURVEY.md §2.4). The scaling story here is embarrassingly parallel
DP over the pixel grid: shard image rows across a 1-D mesh axis ("tiles"),
replicate scene + BVH on every device, render each shard locally, and let
the output sharding reassemble the frame. The collectives are the implicit
all-gather when the caller consumes the image and one scalar psum of the
walk-error count — rays are independent (SURVEY.md §5).

Soft-shadow RNG folds in the mesh axis index so shards draw decorrelated
jitter.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..types import Camera, Light, Mesh as TriMesh, RenderConfig


def make_tile_mesh(devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), ("tiles",))


def _local_frame(tri_mesh: TriMesh, cam: Camera, lights, key, bvh,
                 shade_table, origins, dirs, *, cfg: RenderConfig):
    """Render the local row-shard. Runs inside shard_map: everything except
    (origins, dirs) is replicated. The frame is the single-device one
    (app.render_frame_fn) on this shard's band of rays; the RNG key folds
    in the shard index so soft-shadow jitter decorrelates across shards.
    Returns (image band, walk errors summed over all shards)."""
    from ..app import render_frame_fn
    key = jax.random.fold_in(key, jax.lax.axis_index("tiles"))
    out = render_frame_fn(bvh, tri_mesh, cam, lights, key, cfg, shade_table,
                          rays=(origins, dirs))
    return out["image"], jax.lax.psum(out["trace_errors"], "tiles")


def _pad_rows(rays, hpad: int):
    """Pad (origins, dirs) rows to ``hpad`` with harmless rays (origin 0,
    direction (1, 1, 1)); their pixels are cut off the image again."""
    origins, dirs = rays
    h, w = origins.shape[:2]
    if hpad == h:
        return origins, dirs
    return (jnp.concatenate(
        [origins, jnp.zeros((hpad - h, w, 3), origins.dtype)]),
        jnp.concatenate([dirs, jnp.ones((hpad - h, w, 3), dirs.dtype)]))


def shard_rays(rays, mesh: Mesh):
    """The frame's primary rays padded to a multiple of the device count
    and placed row-sharded over "tiles" — once per camera, so no frame pays
    for moving them."""
    n = mesh.devices.size
    hpad = -(-rays[0].shape[0] // n) * n
    return jax.device_put(_pad_rows(rays, hpad),
                          NamedSharding(mesh, P("tiles")))


def render_frame_sharded(bvh, tri_mesh: TriMesh, cam: Camera, lights, key,
                         cfg: RenderConfig, rays, mesh: Optional[Mesh] = None,
                         shade_table=None):
    """Render one frame with image rows sharded over the mesh's "tiles" axis.

    ``rays``: the frame's primary rays (origins, dirs), f32[H, W, 3] each,
    from camera.camera_rays — the rays the single-device Renderer traces,
    so both give the same image. Place them with shard_rays once per
    camera; rays on one device are resharded on every call.
    ``shade_table`` (passes/shading.make_shade_table of the accel's LBVH)
    is required on the 8-wide accel, as for render_frame_fn.

    Returns (f32[H, W, 3] image, i32[] walk errors): the image is a sharded
    jax.Array (converting it to numpy performs the final gather). The
    traversal (CUDA kernel or XLA walk) runs inside shard_map with
    check_vma=True.
    """
    if mesh is None:
        mesh = make_tile_mesh()
    n = mesh.devices.size
    if isinstance(lights, Light):
        lights = (lights,)
    lights = tuple(lights)

    h = cfg.height
    origins, dirs = _pad_rows(rays, -(-h // n) * n)
    fn = jax.shard_map(
        partial(_local_frame, cfg=cfg),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P("tiles"), P("tiles")),
        out_specs=(P("tiles"), P()),
        check_vma=True,
    )
    img, errors = fn(tri_mesh, cam, lights, key, bvh, shade_table, origins,
                     dirs)
    return img[:h], errors


def sharded_frames(renderer, devices: Sequence):
    """The CLI's ``--shard`` path: key -> (image, walk errors) for a static
    Renderer's scene with image rows sharded over ``devices``.

    The scene, accel, shade table and the Renderer's own primary rays are
    put on the devices once; each call runs one compiled sharded frame."""
    dev_mesh = make_tile_mesh(devices)
    accel, tri_mesh, table = (device_put_replicated(x, dev_mesh) for x in (
        renderer.accel, renderer.mesh, renderer.shade_table))
    rays = shard_rays(renderer.rays, dev_mesh)
    cam, lights, cfg = renderer.camera, tuple(renderer.lights), \
        renderer.config

    @jax.jit
    def frame(accel, tri_mesh, table, rays, key):
        return render_frame_sharded(accel, tri_mesh, cam, lights, key, cfg,
                                    rays, mesh=dev_mesh, shade_table=table)

    return lambda key: frame(accel, tri_mesh, table, rays, key)


def device_put_replicated(tree, mesh: Mesh):
    """Upload scene data replicated across the mesh (the multi-chip analogue
    of the reference's staging-buffer upload)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)
