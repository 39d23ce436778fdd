"""CUDA BVH traversal for the 8-wide accel, called through ``jax.ffi``.

The kernel (native/traverse.cu) traces one ray per thread with a private
stack of ``wide.stack_depth`` entries (sized from the tree when the accel
is built), each warp covering a compact pixel tile, over the ``WideBVH`` rows
(bvh/wide.py) left in device memory. Per-ray stack traversal is the SIMT
workload a GPU is built for: XLA's vmapped ``while_loop``
(bvh/traverse.traverse_wide, the plain twin of this kernel) runs every
chunk of rays until its slowest ray finishes and rewrites the whole stack
array each step.

The library is built from the repo's sources by ``make -C native cuda`` on
first use in a process (a no-op when it is up to date) into the gitignored
``native/build/``. The kernel exists only for CUDA: asking for it on any
other platform raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libtraverse_cuda.so")
_CLOSEST = "rt_closest_hit"
_ANY = "rt_any_hit"
MAX_LEAF_SIZE = 14      # 14 triangles x 9 floats fill one 128-float row

_library = None         # the loaded CDLL, kept alive while targets are used


def require_cuda() -> None:
    """Raise unless JAX runs on a CUDA GPU (the kernel has no other build
    and no interpret mode)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"the CUDA traversal kernel needs an NVIDIA GPU, but JAX runs on "
            f"{dev.platform!r} ({dev.device_kind}); use the plain XLA route "
            f"(RenderConfig(use_kernel=False), --no-kernel)")


def build_library() -> float:
    """Build (if stale) and register the CUDA library; returns the seconds
    the build step took (0 after the first call in a process)."""
    global _library
    if _library is not None:
        return 0.0
    require_cuda()
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["make", "-C", _NATIVE_DIR, "cuda",
         f"JAX_INCLUDE={jax.ffi.include_dir()}"],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"building {LIB_PATH} failed:\n{proc.stdout}"
                           f"\n{proc.stderr}")
    lib = ctypes.CDLL(LIB_PATH)
    jax.ffi.register_ffi_target(_CLOSEST, jax.ffi.pycapsule(lib.RtClosestHit),
                                platform="CUDA")
    jax.ffi.register_ffi_target(_ANY, jax.ffi.pycapsule(lib.RtAnyHit),
                                platform="CUDA")
    _library = lib
    seconds = time.perf_counter() - t0
    print(f"tpurt: CUDA traversal library ready in {seconds:.1f} s "
          f"({LIB_PATH})", file=sys.stderr)
    return seconds


def launch_geometry(ray_shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(width, height, tile_w) for rays of leading shape ``ray_shape``.

    Rays are traced in row-major order as a width x height grid: the last
    leading axis is the width (image columns), the rest fold into the
    height. Each warp takes a tile_w x (32 / tile_w) tile — 8 x 4 pixels
    for image grids, 32 x 1 for flat ray lists."""
    if len(ray_shape) == 0:
        return 1, 1, 32
    width = int(ray_shape[-1])
    height = int(np.prod(ray_shape[:-1], dtype=np.int64))
    return width, height, (8 if height >= 4 else 32)


def pack_rays(origins, dirs, t_max) -> jnp.ndarray:
    """(..., 3) origins/dirs + scalar or per-ray t_max -> f32[N, 8] rows
    (origin.xyz, dir.xyz, t_max, 0): two float4 loads per ray."""
    shape = origins.shape[:-1]
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), shape)
    rays = jnp.concatenate(
        [origins.astype(jnp.float32), dirs.astype(jnp.float32),
         tm[..., None], jnp.zeros(shape + (1,), jnp.float32)], axis=-1)
    return rays.reshape(-1, 8)


def _check_accel(wide) -> None:
    from ..bvh.wide import STACK_SIZES, WideBVH
    if not isinstance(wide, WideBVH):
        raise TypeError(f"the CUDA kernel traces a WideBVH, got "
                        f"{type(wide).__name__} (binary accels take the "
                        f"plain XLA walk)")
    if not 1 <= wide.leaf_size <= MAX_LEAF_SIZE:
        raise ValueError(f"leaf_size {wide.leaf_size} does not fit one "
                         f"128-float leaf row (max {MAX_LEAF_SIZE})")
    if wide.stack_depth not in STACK_SIZES:
        raise ValueError(f"stack_depth {wide.stack_depth} is not one of the "
                         f"kernel's sizes {STACK_SIZES}")


def _call(target, result_dtypes, wide, origins, dirs, t_max, t_min):
    _check_accel(wide)
    build_library()
    shape = origins.shape[:-1]
    width, height, tile_w = launch_geometry(shape)
    n = width * height
    if n == 0:
        return ([jnp.zeros(shape, dt) for dt in result_dtypes],
                jnp.int32(0))
    # Under shard_map(check_vma=True) every operand and result must vary
    # over the same mesh axes: the replicated accel is cast to the rays'
    # axes, and the results vary like the rays do.
    rays = pack_rays(origins, dirs, t_max)
    ray_type = jax.typeof(rays)
    vma = ray_type.vma
    nodes, tris = wide.nodes, wide.tris
    if vma:
        nodes, tris = (jax.lax.pcast(a, tuple(vma - jax.typeof(a).vma),
                                     to="varying") for a in (nodes, tris))
    scalar = NamedSharding(ray_type.sharding.mesh, PartitionSpec())
    outs = [jax.ShapeDtypeStruct((n,), dt, sharding=scalar, vma=vma)
            for dt in result_dtypes]
    outs.append(jax.ShapeDtypeStruct((), jnp.int32, sharding=scalar,
                                     vma=vma))
    call = jax.ffi.ffi_call(target, outs, vmap_method="sequential")
    res = call(nodes, tris, rays,
               t_min=np.float32(t_min), width=np.int32(width),
               height=np.int32(height), tile_w=np.int32(tile_w),
               leaf_size=np.int32(wide.leaf_size),
               max_iters=np.int32(2 * wide.num_wide + 64),
               stack_depth=np.int32(wide.stack_depth))
    return [r.reshape(shape) for r in res[:-1]], res[-1]


def trace_closest_cuda(wide, origins, dirs, t_max=jnp.inf,
                       t_min: float = 0.0):
    """Closest hit: (t f32[...], sorted triangle index i32[...], errors
    i32[]) — the contract of bvh.traverse.traverse_wide."""
    (t, sidx), errors = _call(_CLOSEST, (jnp.float32, jnp.int32), wide,
                              origins, dirs, t_max, t_min)
    return t, sidx, errors


def trace_any_cuda(wide, origins, dirs, t_max, t_min: float = 0.0):
    """Occlusion: (bool[...] True where something lies in (t_min, t_max),
    errors i32[]). Rays with t_max <= t_min are inactive."""
    (occ,), errors = _call(_ANY, (jnp.int32,), wide, origins, dirs, t_max,
                           t_min)
    return occ > 0, errors
