"""tpurt — ray-traced shadows renderer in JAX.

A rebuild of the capabilities of kayru/RayTracedShadows (C++/Vulkan): OBJ
scene loading, primary-visibility G-buffer, LBVH build/refit fully on
device, and a CUDA BVH traversal kernel (called through jax.ffi, with a
plain-XLA twin) for per-pixel rays. See README.md / BASELINE.md.
"""

from .types import (Camera, Light, Mesh, RenderConfig,
                    LIGHT_AREA_CONE, LIGHT_DIRECTIONAL, LIGHT_POINT)

__all__ = [
    "Camera", "Light", "Mesh", "RenderConfig",
    "LIGHT_AREA_CONE", "LIGHT_DIRECTIONAL", "LIGHT_POINT",
]

__version__ = "0.1.0"
