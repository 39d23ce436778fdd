"""Core data types for the tpurt renderer.

These are the equivalents of the reference app's resource structs:

- ``Mesh``          <- vertex/index buffers built by ``loadModel()``
                       (reference: Source/RayTracedShadows.cpp, model-loading
                       section [RECALL; mount empty at survey time]).
- ``Camera``        <- Rush ``CameraManipulator`` state + projection setup.
- ``Light``         <- the single directional light in the reference's
                       ``Constants`` uniform block; extended with point/area
                       (cone) lights for the soft-shadow / multi-light configs
                       in BASELINE.json.
- ``RenderConfig``  <- Rush ``AppConfig`` (width/height/...) + command line.

All array-bearing types are registered as JAX pytrees so they can flow through
``jit`` / ``shard_map`` directly; static configuration lives in hashable
dataclasses used as static args.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import numpy as np


def _register_pytree(cls, array_fields: Tuple[str, ...], static_fields: Tuple[str, ...] = ()):
    """Register a dataclass as a JAX pytree with the given array/static split."""

    def flatten(obj):
        children = tuple(getattr(obj, f) for f in array_fields)
        aux = tuple(getattr(obj, f) for f in static_fields)
        return children, aux

    def unflatten(aux, children):
        kwargs = dict(zip(array_fields, children))
        kwargs.update(dict(zip(static_fields, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@dataclasses.dataclass
class Mesh:
    """Triangle mesh: the GPU-ready vertex/index buffers of the reference.

    vertices : f32[V, 3] positions
    normals  : f32[V, 3] per-vertex (smooth) normals
    indices  : i32[T, 3] triangle vertex indices
    albedo   : f32[T, 3] per-triangle albedo color (flat-material path;
               also the fallback for untextured triangles)
    uv       : f32[V, 2] per-vertex texture coordinates, or None
    tex_atlas: f32[NT, R, R, 3] stacked square diffuse textures (one
               fixed-resolution atlas array: every sample is one
               computed-index gather, no per-texture shapes), or
               None. The reference samples a diffuse texture for albedo
               (Model.frag [RECALL]); here texturing is OPT-IN per mesh.
    tri_tex  : i32[T] per-triangle atlas layer (-1 = flat albedo), or None
    """

    vertices: Any
    normals: Any
    indices: Any
    albedo: Any
    uv: Any = None
    tex_atlas: Any = None
    tri_tex: Any = None

    @property
    def textured(self) -> bool:
        return self.tex_atlas is not None and self.uv is not None \
            and self.tri_tex is not None

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        v = np.asarray(self.vertices)
        return v.min(axis=0), v.max(axis=0)


_register_pytree(Mesh, ("vertices", "normals", "indices", "albedo",
                        "uv", "tex_atlas", "tri_tex"))


@dataclasses.dataclass
class Camera:
    """Pinhole camera (look-at + vertical FOV), matching the reference's
    fly-camera projection (Rush CameraManipulator + perspective matrix).

    position : f32[3] eye position
    target   : f32[3] look-at point
    up       : f32[3] up hint
    fov_y    : scalar, vertical field of view in radians
    znear    : scalar near plane (used only for depth normalization)
    zfar     : scalar far plane
    """

    position: Any
    target: Any
    up: Any
    fov_y: Any
    znear: Any
    zfar: Any

    @staticmethod
    def look_at(position, target, up=(0.0, 1.0, 0.0), fov_y_deg: float = 60.0,
                znear: float = 0.01, zfar: float = 10_000.0) -> "Camera":
        return Camera(
            position=np.asarray(position, np.float32),
            target=np.asarray(target, np.float32),
            up=np.asarray(up, np.float32),
            fov_y=np.float32(np.deg2rad(fov_y_deg)),
            znear=np.float32(znear),
            zfar=np.float32(zfar),
        )


_register_pytree(Camera, ("position", "target", "up", "fov_y", "znear", "zfar"))


# Light kinds (static ints so they can gate jit-time branches).
LIGHT_DIRECTIONAL = 0  # reference's single directional light
LIGHT_POINT = 1        # extension: point light with finite distance
LIGHT_AREA_CONE = 2    # extension: "sun with angular radius" for soft shadows


@dataclasses.dataclass
class Light:
    """A light source.

    kind       : static int (LIGHT_*)
    direction  : f32[3] unit vector pointing FROM the scene TOWARD the light
                 (i.e. shadow-ray direction), for directional/cone lights
    position   : f32[3] world position for point lights
    color      : f32[3] radiance scale
    intensity  : scalar multiplier
    angular_radius : scalar, half-angle (radians) of the solid-angle cone for
                 LIGHT_AREA_CONE soft shadows (config 3 in BASELINE.json)
    radius     : scalar, source radius for point lights (soft penumbra)
    """

    direction: Any
    position: Any
    color: Any
    intensity: Any
    angular_radius: Any
    radius: Any
    kind: int = LIGHT_DIRECTIONAL

    @staticmethod
    def directional(direction, color=(1.0, 1.0, 1.0), intensity: float = 1.0) -> "Light":
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        return Light(direction=d, position=np.zeros(3, np.float32),
                     color=np.asarray(color, np.float32),
                     intensity=np.float32(intensity),
                     angular_radius=np.float32(0.0), radius=np.float32(0.0),
                     kind=LIGHT_DIRECTIONAL)

    @staticmethod
    def sun(direction, angular_radius_deg: float = 0.53, color=(1.0, 1.0, 1.0),
            intensity: float = 1.0) -> "Light":
        """Directional light with angular extent -> soft shadows (config 3)."""
        l = Light.directional(direction, color, intensity)
        return dataclasses.replace(
            l, angular_radius=np.float32(np.deg2rad(angular_radius_deg)),
            kind=LIGHT_AREA_CONE)

    @staticmethod
    def point(position, color=(1.0, 1.0, 1.0), intensity: float = 1.0,
              radius: float = 0.0) -> "Light":
        return Light(direction=np.array([0, 1, 0], np.float32),
                     position=np.asarray(position, np.float32),
                     color=np.asarray(color, np.float32),
                     intensity=np.float32(intensity),
                     angular_radius=np.float32(0.0),
                     radius=np.float32(radius), kind=LIGHT_POINT)


_register_pytree(
    Light,
    ("direction", "position", "color", "intensity", "angular_radius", "radius"),
    ("kind",),
)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (hashable -> usable as a jit static arg).

    Mirrors the reference's AppConfig + command line, extended with the
    BASELINE.json config axes (spp, sort toggle, build-vs-refit mode).
    """

    width: int = 512
    height: int = 512
    spp: int = 1                     # shadow rays per pixel (config 3: 4..16)
    ambient: float = 0.08
    shadow_bias: float = 1e-3        # normal-offset bias, like the reference
    background: Tuple[float, float, float] = (0.18, 0.22, 0.30)
    leaf_size: int = 4               # triangles per BVH leaf
    bvh_width: int = 8               # accel arity: 2 (binary) or 8 (wide)
    # Who walks the 8-wide accel: the hand-written CUDA kernel
    # (kernels/traverse.py) or the plain XLA walk (bvh/traverse.py). The
    # kernel exists only on a CUDA GPU: runs elsewhere choose False.
    use_kernel: bool = True
    sort_rays: bool = False          # ray sorting for coherence (config 5)
    accumulate: bool = False         # temporal accumulation (config 3)
    seed: int = 0
    # Static/refit scenes: build with the native host SAH builder when
    # available (the reference's own startup strategy).
    sah: bool = True
    # Near-first child ordering of the G-buffer accel w.r.t. the camera
    # (bvh/wide.order_children_for_point). Renderer turns it off for
    # clustered rebuild mode, whose per-frame accel is rebuilt anyway.
    order_children: bool = True
    # Rebuild-mode sub-leaf clustering: split the top-M triangle blocks at
    # their largest internal Morton jump into two tight-boxed tree-leaves
    # (bvh/lbvh._subleaf_split). 0 = off, -1 = auto
    # (lbvh.auto_split_blocks), > 0 = exact M.
    rebuild_splits: int = -1

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
