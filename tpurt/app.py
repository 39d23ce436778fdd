"""Renderer: the application shell / frame loop.

The equivalent of ``class RayTracedShadowsApp`` in
Source/RayTracedShadows.cpp [RECALL]: owns the scene resources (device
arrays), builds the acceleration structure, and records the three passes per
frame — except here the "passes" are one jitted function and the "resources"
are jax.Arrays. Headless: frames are returned as arrays / written as PNGs
instead of presented to a swapchain.

Mode axis (BASELINE configs):
  static  — build once, trace every frame (reference behavior)
  rebuild — full LBVH rebuild every frame (config 2)
  refit   — per-frame AABB refit for deforming meshes (config 4), with an
            automatic SAH-degradation rebuild policy

Routes: ``RenderConfig.bvh_width`` picks the accel (8-wide rows or the
binary LBVH) and ``RenderConfig.use_kernel`` picks who walks it — the CUDA
kernel (kernels/traverse.py, 8-wide only) or plain XLA (bvh/traverse.py).
"""

from __future__ import annotations

import dataclasses
import sys
from functools import partial
from typing import Dict, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .bvh.lbvh import LBVH, build_lbvh, refit_lbvh, sah_cost
from .bvh.wide import WideBVH, order_children_for_point, size_stack, \
    stack_size_for, wide_count_device, wide_levels_device, widen_lbvh
from .bvh import traverse as jax_traverse
from .camera import camera_rays
from .passes.shading import make_shade_table
from .passes.composite import accumulate, composite_pass
from .passes.gbuffer import gbuffer_pass
from .passes.shadow import shadow_pass
from .types import (LIGHT_AREA_CONE, LIGHT_POINT, Camera, Light, Mesh,
                    RenderConfig)
from .utils.metrics import FrameStats, Timer, mrays_per_s


def make_tracers(cfg: RenderConfig):
    """(trace_closest, trace_any) as functions of (accel, rays...).

    trace_closest(accel, o, d) -> (t, tri_id | None, sorted index | None,
    errors); trace_any(accel, o, d, t_max) -> (occluded, errors). ``errors``
    counts walks that overflowed their stack or hit the iteration cap. A
    ``WideBVH`` is walked by the CUDA kernel (cfg.use_kernel) or by its
    plain XLA twin, both returning the sorted index; the binary LBVH has
    the XLA walk only, returning the original triangle id.
    """
    if cfg.use_kernel:
        from .kernels.traverse import trace_any_cuda, trace_closest_cuda

    def check_binary(accel):
        if cfg.use_kernel:
            raise ValueError("the CUDA kernel walks the 8-wide accel only "
                             "(bvh_width=8); binary accels take the plain "
                             "route (use_kernel=False)")

    def closest(accel, o, d):
        if isinstance(accel, WideBVH):
            fn = trace_closest_cuda if cfg.use_kernel \
                else jax_traverse.traverse_wide
            t, sidx, errors = fn(accel, o, d)
            return t, None, sidx, errors
        check_binary(accel)
        t, tid = jax_traverse.traverse(accel, o, d, t_min=0.0, any_hit=False)
        return t, tid, None, jnp.int32(0)

    def any_(accel, o, d, t_max):
        if isinstance(accel, WideBVH):
            if cfg.use_kernel:
                return trace_any_cuda(accel, o, d, t_max)
            _, sidx, errors = jax_traverse.traverse_wide(
                accel, o, d, t_max=t_max, any_hit=True)
            return sidx >= 0, errors
        check_binary(accel)
        _, tid = jax_traverse.traverse(accel, o, d, t_min=0.0, t_max=t_max,
                                       any_hit=True)
        return tid >= 0, jnp.int32(0)

    if cfg.sort_rays:
        from .passes.sort import make_sorted_tracer

        raw_any = any_

        def any_(accel, o, d, t_max):  # noqa: F811 - deliberate wrap
            sorted_tracer = make_sorted_tracer(
                lambda so, sd, stm: raw_any(accel, so, sd, stm),
                accel.root_min, accel.root_max)
            return sorted_tracer(o, d, t_max)

    return closest, any_


@partial(jax.jit, static_argnames=("leaf_size", "nw_pad", "stack_depth",
                                   "split_blocks"))
def _rebuild_fused(vertices, indices, mesh, leaf_size: int, nw_pad: int,
                   stack_depth: int = 64, split_blocks: int = 0):
    """Config-2 hot path: LBVH build + 8-wide collapse (the fixed depth-3
    cut: only the wide nodes' boxes are ever needed, so the build defers
    node boxes) + shading table as ONE device program — no host syncs.

    The wide-node count and the tree's wide levels ride along as device
    scalars, so callers can check the pad and the walks' stack
    (``stack_depth``, sized for an earlier tree) opportunistically."""
    bvh = build_lbvh(vertices, indices, leaf_size=leaf_size, boxes="defer",
                     split_blocks=split_blocks)
    wide = widen_lbvh(bvh, nw_pad=nw_pad, mode="fixed")
    wide = dataclasses.replace(wide, stack_depth=stack_depth)
    cnt = wide_count_device(bvh, mode="fixed")
    return (bvh, wide, make_shade_table(bvh, mesh), cnt,
            wide_levels_device(wide.nodes))


@jax.jit
def _clip_refit_fused(plan, bvh, vertices, mesh):
    """Config-4 hot path: clip-geometry SBVH refit + wide assembly +
    shading table as ONE device program (bvh/clip_refit.py). Preserves the
    static tree's spatial-split quality under deformation."""
    from .bvh.clip_refit import refit_sbvh_wide
    wide, refit = refit_sbvh_wide(plan, bvh, None, None, None,
                                  vertices=vertices)
    return refit, wide, make_shade_table(refit, mesh)


def _sah_available() -> bool:
    from . import native
    return native.available()


def gbuffer_production(bvh, mesh: Mesh, cam: Camera, cfg: RenderConfig,
                       shade_table=None, rays=None) -> Dict[str, jnp.ndarray]:
    """The primary-visibility pass for this config/accel — the single
    source of truth used by the frame (render_frame_fn), the sharded frame
    (parallel/tiling.py) and profile mode (Renderer._profile_passes).

    rays: optional precomputed (origins, dirs) — a shard passes its band."""
    trace_closest, _ = make_tracers(cfg)
    gb_accel = bvh
    if isinstance(bvh, WideBVH) and cfg.order_children:
        # Near-first child ordering w.r.t. the camera: primary rays pop
        # near children first so best_t culls the far ones.
        gb_accel = order_children_for_point(bvh, cam.position)
    height = rays[0].shape[0] if rays is not None else cfg.height
    gbuf = gbuffer_pass(lambda o, d: trace_closest(gb_accel, o, d), mesh,
                        cam, cfg.width, height, shade_table=shade_table,
                        rays=rays)
    if mesh.textured:
        from .passes.texture import apply_textures
        gbuf = {**gbuf, "albedo": apply_textures(mesh, gbuf)}
    return gbuf


def shadow_production(bvh, gbuf: Dict[str, jnp.ndarray], light: Light,
                      key: jax.Array, cfg: RenderConfig):
    """One light's shadow pass -> (visibility, errors); shared by the
    frame, the sharded frame and profile mode."""
    _, trace_any = make_tracers(cfg)
    return shadow_pass(
        lambda o, d, tm: trace_any(bvh, o, d, tm),
        gbuf, light, cfg.spp, key, cfg.shadow_bias,
        scene_bounds=(bvh.root_min, bvh.root_max))


@partial(jax.jit, static_argnames=("cfg",))
def render_frame_fn(bvh, mesh: Mesh, cam: Camera, lights: Sequence[Light],
                    key: jax.Array, cfg: RenderConfig, shade_table=None,
                    rays=None) -> Dict[str, jnp.ndarray]:
    """One fused frame: G-buffer -> per-light shadow batches -> composite.

    ``shade_table`` (passes/shading.make_shade_table of the accel's LBVH)
    is required on the 8-wide accel, whose walks return sorted indices.
    ``rays``: optional precomputed (origins, dirs) — the Renderer's
    camera rays (camera.camera_rays), or a shard's band of them in the
    sharded frame (parallel/tiling.py); generated here when absent.
    ``out["trace_errors"]`` sums every pass's walk errors."""
    gbuf = gbuffer_production(bvh, mesh, cam, cfg, shade_table, rays=rays)
    errors = gbuf.pop("trace_errors")
    shadows = []
    for li, light in enumerate(lights):
        vis, err = shadow_production(bvh, gbuf, light,
                                     jax.random.fold_in(key, li), cfg)
        shadows.append(vis)
        errors = errors + err
    # Composite: sum of per-light direct terms + one ambient term.
    img = composite_pass(gbuf, shadows[0], lights[0], cfg.ambient,
                         cfg.background)
    for li in range(1, len(lights)):
        extra = composite_pass(gbuf, shadows[li], lights[li], 0.0,
                               (0.0, 0.0, 0.0))
        img = jnp.where(gbuf["valid"][..., None], img + extra, img)
    return {"image": img, "shadow": jnp.stack(shadows), **gbuf,
            "trace_errors": errors}


class TraceError(RuntimeError):
    """A traversal walk overflowed its stack or hit its iteration cap."""


def check_trace_errors(errors, where: str) -> None:
    n = int(np.asarray(errors))
    if n:
        raise TraceError(f"{n} ray walks in {where} overflowed the traversal "
                         f"stack or hit the iteration cap")


class Renderer:
    """Owns scene + BVH and renders frames. See module docstring."""

    def __init__(self, mesh: Mesh, camera: Camera,
                 lights: Union[Light, Sequence[Light]],
                 config: RenderConfig = RenderConfig(),
                 mode: str = "static",
                 rebuild_threshold: float = 1.6,
                 cache_dir: Optional[str] = None):
        if isinstance(lights, Light):
            lights = [lights]
        assert mode in ("static", "rebuild", "refit")
        if config.use_kernel:
            if config.bvh_width != 8:
                raise ValueError("the CUDA kernel walks the 8-wide accel "
                                 "only; use bvh_width=8 or use_kernel=False")
            from .kernels.traverse import build_library
            build_library()               # raises off CUDA
        # Static/refit scenes use the native host SAH build when available
        # (the reference's own startup strategy); per-frame rebuilds
        # (config 2) keep the on-device LBVH, as do scenes that fit one
        # leaf (a single-leaf SAH tree has no internal node to store).
        want_sah = (config.sah and mode != "rebuild"
                    and config.bvh_width == 8
                    and mesh.num_triangles > config.leaf_size)
        self._use_sah = want_sah and _sah_available()
        if want_sah and not self._use_sah:
            print("tpurt: native SAH library unavailable; building the "
                  "on-device Morton LBVH instead", file=sys.stderr)
        self._rebuild_splits = 0
        if mode == "rebuild" and config.rebuild_splits:
            from .bvh.lbvh import auto_split_blocks
            self._rebuild_splits = (
                auto_split_blocks(mesh.num_triangles, config.leaf_size)
                if config.rebuild_splits < 0 else config.rebuild_splits)
            # Camera-ordering the accel loses on clustered rebuilt trees
            # (see RenderConfig.order_children).
            config = dataclasses.replace(config, order_children=False)
        self.config = config
        self.mode = mode
        self.rebuild_threshold = rebuild_threshold
        self.set_camera(camera)
        self.lights = list(lights)
        self.mesh = jax.device_put(mesh)
        self._build_jit = jax.jit(partial(
            build_lbvh, leaf_size=config.leaf_size,
            split_blocks=self._rebuild_splits))
        self._refit_jit = jax.jit(refit_lbvh)
        self.frame_index = 0
        self._geom_dirty = False
        self._nw_pad: Optional[int] = None
        self.accum: Optional[jnp.ndarray] = None
        self.stats = FrameStats(width=config.width, height=config.height,
                                spp=config.spp, num_lights=len(self.lights),
                                mode=mode)
        timer = Timer()
        with timer.section("build", None):
            self.bvh = self._build_or_load_cached(mesh, cache_dir)
            self.accel = self._make_accel()
            self._clip_plan = self._make_clip_plan()
        self.stats.build_ms = timer.ms["build"]
        self._base_cost = float(sah_cost(self.bvh))
        stack = (f"; {self.accel.stack_depth}-entry walk stack"
                 if isinstance(self.accel, WideBVH) else "")
        print(f"tpurt: accel = {self.accel_kind}{stack}", file=sys.stderr)

    @property
    def accel_kind(self) -> str:
        """Which accel this renderer built, for logs and checks."""
        tree = ("native host SBVH" if self._use_sah
                else "on-device Morton LBVH")
        if self.config.bvh_width != 8:
            return f"{tree}, binary, XLA walk"
        walk = "CUDA kernel" if self.config.use_kernel else "XLA walk"
        return f"{tree}, 8-wide, {walk}"

    def _build_or_load_cached(self, host_mesh: Mesh,
                              cache_dir: Optional[str]):
        """Content-addressed BVH cache (SURVEY.md §5): skip the build when
        this exact geometry was built before (the reference rebuilds its CPU
        BVH on every startup)."""
        key = None
        if cache_dir is not None:
            from .checkpoint import load_bvh, scene_key
            key = scene_key(np.asarray(host_mesh.vertices),
                            np.asarray(host_mesh.indices),
                            self.config.leaf_size)
            if self._use_sah:
                from .bvh.sah import SAH_VARIANT
                key += "-" + SAH_VARIANT
            if self._rebuild_splits:
                key += f"-sp{self._rebuild_splits}"
            cached = load_bvh(cache_dir, key)
            if cached is not None:
                return jax.device_put(cached)
        if self._use_sah:
            from .bvh.sah import build_sah_lbvh
            bvh = jax.device_put(build_sah_lbvh(host_mesh,
                                                self.config.leaf_size))
        else:
            bvh = jax.block_until_ready(
                self._build_jit(self.mesh.vertices, self.mesh.indices))
        if key is not None:
            from .checkpoint import save_bvh
            save_bvh(cache_dir, key, jax.device_get(bvh))
        return bvh

    def _make_accel(self):
        """Traversal-facing accel: the 8-wide rows (bvh_width=8) or the
        LBVH itself. The ONLY host sync for the wide-node count happens
        here — once per scene (or per overflow recovery) — and the padded
        count is cached so per-frame rebuilds run as one fused device
        program (_rebuild_fused)."""
        self.shade_table = jax.jit(make_shade_table)(self.bvh, self.mesh)
        self._nw_pad = None
        if self.config.bvh_width != 8:
            return self.bvh
        from .bvh.wide import count_wide, make_wide_plan, round_up_bucket
        # The rebuild hot path collapses with the fixed cut every frame, so
        # its pad must be counted the same way; static/refit scenes take
        # the default (area) frontier.
        collapse_mode = "fixed" if self.mode == "rebuild" else None
        nw_pad = round_up_bucket(
            max(count_wide(self.bvh, mode=collapse_mode), 1))
        self._nw_pad = nw_pad
        if self.bvh.leaf_block is not None:
            # Sub-leaf clustered tree (rebuild mode): no refit plan — the
            # per-frame path rebuilds from scratch; widen the as-built
            # accel directly.
            from .bvh.wide import _widen_jit
            self._wide_plan = None
            return size_stack(_widen_jit(self.bvh, nw_pad=nw_pad,
                                         mode=collapse_mode))
        self._wide_plan = jax.jit(
            make_wide_plan, static_argnames=("nw_pad", "mode"))(
                self.bvh, nw_pad=nw_pad, mode=collapse_mode)
        from .bvh.wide import leaf_boxes_from_nodes, widen_from_plan
        # Leaf slots take the builder's STORED boxes where available: on
        # SBVH topologies these are the clipped reference boxes (strictly
        # tighter than the full-triangle union). Refits re-derive leaf
        # boxes from the deformed geometry instead (clip_refit /
        # widen_from_plan defaults), so this only feeds the as-built accel.
        leaf_boxes = None
        if self.bvh.nodes_box is not None:
            leaf_boxes = jax.jit(leaf_boxes_from_nodes)(self.bvh)
        return size_stack(jax.jit(widen_from_plan)(
            self._wide_plan, self.bvh, leaf_boxes=leaf_boxes))

    def _make_clip_plan(self):
        """Refit-mode precompute: barycentric clip polygons per leaf slot
        (bvh/clip_refit.py), evaluated ON DEVICE. Valid for any frozen
        topology; pays off most on SBVH trees, whose clipped boxes a
        full-triangle refit would forfeit."""
        if self.mode != "refit" or self._nw_pad is None:
            return None
        from .bvh.clip_refit import (ClipRefitPlan, clip_slots_bary_device,
                                     slot_boxes_from_nodes)
        bmin, bmax = slot_boxes_from_nodes(self.bvh)
        bary, slack = jax.jit(clip_slots_bary_device)(
            self.bvh.tri_v0, self.bvh.tri_e1, self.bvh.tri_e2, bmin, bmax)
        return ClipRefitPlan(bary=bary, plan=self._wide_plan, slack=slack)

    def _refit_accel(self):
        """Refit fast path: topology (and therefore the wide plan and the
        walks' stack size) is frozen, so only boxes are re-gathered — no
        count host-sync. The shading table holds geometry (v0/e1/e2,
        normals) and must follow."""
        self.shade_table = jax.jit(make_shade_table)(self.bvh, self.mesh)
        if self._nw_pad is not None:
            from .bvh.wide import widen_from_plan
            return dataclasses.replace(
                jax.jit(widen_from_plan)(self._wide_plan, self.bvh),
                stack_depth=self.accel.stack_depth)
        return self.bvh

    # -- scene updates ------------------------------------------------------

    def set_camera(self, camera: Camera) -> None:
        """New camera; its primary rays are generated once, here, by the
        same compiled program the sharded frame takes them from
        (parallel/tiling.sharded_frames), so both trace identical rays."""
        self.camera = camera
        self.rays = camera_rays(camera, self.config.width,
                                self.config.height)

    def set_lights(self, lights: Union[Light, Sequence[Light]]) -> None:
        if isinstance(lights, Light):
            lights = [lights]
        self.lights = list(lights)
        self.stats.num_lights = len(self.lights)

    def set_vertices(self, vertices) -> None:
        """Animate: new vertex positions, same topology (config 4). Vertex
        normals are recomputed on device so shading follows the motion."""
        from .passes.shading import smooth_normals_device
        v = jax.device_put(jnp.asarray(vertices))
        normals = jax.jit(smooth_normals_device)(v, self.mesh.indices)
        self.mesh = dataclasses.replace(self.mesh, vertices=v,
                                        normals=normals)
        # New geometry can change the wide-node count: the next rebuild
        # verifies the cached pad against the on-device count.
        self._geom_dirty = True

    # -- frame loop ---------------------------------------------------------

    def _update_bvh(self, timer: Timer) -> None:
        if self.mode == "rebuild":
            with timer.section("build", None):
                if self._nw_pad is not None:
                    # Fused build+collapse+shading-table: one device program,
                    # no per-frame host sync for the wide-node count.
                    depth = self.accel.stack_depth
                    bvh, accel, st, cnt, levels = _rebuild_fused(
                        self.mesh.vertices, self.mesh.indices, self.mesh,
                        self.config.leaf_size, self._nw_pad,
                        stack_depth=depth,
                        split_blocks=self._rebuild_splits)
                    overflow = False
                    if self._geom_dirty:
                        # Geometry changed since the pad and the stack were
                        # sized: check the on-device count and depth once
                        # (the program has already run; these are scalar
                        # fetches, not extra compute).
                        cnt, levels = jax.device_get((cnt, levels))
                        overflow = (int(cnt) > self._nw_pad
                                    or stack_size_for(int(levels)) > depth)
                        self._geom_dirty = False
                    if overflow:
                        # Pad or stack overflow: recount + re-plan (host
                        # sync) — the recovery path; rendering never sees
                        # the truncated collapse or a short stack.
                        self.bvh = jax.block_until_ready(
                            self._build_jit(self.mesh.vertices,
                                            self.mesh.indices))
                        self.accel = self._make_accel()
                    else:
                        self.bvh, self.accel, self.shade_table = \
                            bvh, accel, st
                        jax.block_until_ready(accel.nodes)
                else:
                    self.bvh = jax.block_until_ready(
                        self._build_jit(self.mesh.vertices,
                                        self.mesh.indices))
                    self.accel = self._make_accel()
            self.stats.build_ms = timer.ms["build"]
        elif self.mode == "refit":
            with timer.section("refit", None):
                if self._clip_plan is not None:
                    # Clip-geometry refit (bvh/clip_refit.py): one fused
                    # program, preserves the static SBVH's spatial-split
                    # quality. The frozen topology keeps its stack size.
                    self.bvh, accel, self.shade_table = \
                        _clip_refit_fused(self._clip_plan, self.bvh,
                                          self.mesh.vertices, self.mesh)
                    self.accel = dataclasses.replace(
                        accel, stack_depth=self.accel.stack_depth)
                    jax.block_until_ready(self.accel.nodes)
                else:
                    self.bvh = jax.block_until_ready(
                        self._refit_jit(self.bvh, self.mesh.vertices,
                                        self.mesh.indices))
                    self.accel = self._refit_accel()
            self.stats.refit_ms = timer.ms["refit"]
            cost = float(sah_cost(self.bvh))
            if cost > self._base_cost * self.rebuild_threshold:
                # Refit quality degraded past the policy threshold: rebuild
                # (the SAH path rebuilds on host with the CURRENT vertices).
                with timer.section("build", None):
                    if self._use_sah:
                        from .bvh.sah import build_sah_lbvh
                        host = dataclasses.replace(
                            self.mesh,
                            vertices=np.asarray(self.mesh.vertices),
                            indices=np.asarray(self.mesh.indices))
                        self.bvh = jax.device_put(build_sah_lbvh(
                            host, self.config.leaf_size))
                    else:
                        self.bvh = jax.block_until_ready(
                            self._build_jit(self.mesh.vertices,
                                            self.mesh.indices))
                    self.accel = self._make_accel()
                    # Topology changed: the clip polygons and collapse plan
                    # are stale — re-derive them for the new tree.
                    self._clip_plan = self._make_clip_plan()
                self.stats.build_ms = timer.ms["build"]
                self._base_cost = float(sah_cost(self.bvh))

    def render_frame(self, profile: bool = False) -> Dict[str, np.ndarray]:
        """Render one frame; returns the output dict (device arrays).

        profile=True re-runs the passes split at pass boundaries to collect
        per-pass timings (the HUD path); the returned image always comes from
        the fused pipeline. Raises TraceError if any ray walk overflowed.
        """
        cfg = self.config
        timer = Timer()
        self._update_bvh(timer)
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed),
                                 self.frame_index)
        with timer.section("frame", None):
            out = render_frame_fn(self.accel, self.mesh, self.camera,
                                  tuple(self.lights), key, cfg,
                                  shade_table=self.shade_table,
                                  rays=self.rays)
            jax.block_until_ready(out["image"])
        self.stats.frame_ms = timer.ms["frame"]
        valid, errors = jax.device_get((jnp.sum(out["valid"]),
                                        out["trace_errors"]))
        check_trace_errors(errors, f"frame {self.frame_index}")

        if profile:
            self._profile_passes(key, timer)

        if cfg.accumulate:
            if self.accum is None:
                self.accum = out["image"]
            else:
                self.accum = accumulate(self.accum,
                                        jnp.int32(self.frame_index),
                                        out["image"])
            out = dict(out)
            out["image"] = self.accum

        self.stats.rays_primary = cfg.num_pixels

        def _rays_per_pixel(light) -> int:
            # shadow_pass only multi-samples soft lights (area-cone/point
            # at spp > 1); hard lights trace exactly one ray per pixel.
            soft = light.kind in (LIGHT_AREA_CONE, LIGHT_POINT) \
                and cfg.spp > 1
            return cfg.spp if soft else 1

        self.stats.rays_shadow = int(valid) * sum(
            _rays_per_pixel(l) for l in self.lights)
        # Mrays/s is shadow rays / SHADOW-PASS seconds (the BASELINE
        # metric); the shadow pass is only timed in profile mode, so
        # without it the metric is reported as 0 ("not measured").
        if profile:
            self.stats.mrays_per_s = mrays_per_s(
                self.stats.rays_shadow, self.stats.shadow_ms / 1e3)
        else:
            self.stats.shadow_ms = 0.0
            self.stats.gbuffer_ms = 0.0
            self.stats.composite_ms = 0.0
            self.stats.mrays_per_s = 0.0
        self.frame_index += 1
        return out

    def _profile_passes(self, key, timer: Timer) -> None:
        """Per-pass timings via the SAME pass constructors the fused frame
        uses — a profile of any other code path would misreport
        gbuffer_ms/shadow_ms and the Mrays/s derived from them."""
        cfg = self.config
        gb = jax.jit(partial(gbuffer_production, cfg=cfg))
        with timer.section("gbuffer"):
            gbuf = gb(self.accel, self.mesh, self.camera,
                      shade_table=self.shade_table, rays=self.rays)
            jax.block_until_ready(gbuf["t"])
        gbuf.pop("trace_errors")
        sp = jax.jit(partial(shadow_production, cfg=cfg))
        with timer.section("shadow"):
            masks = [sp(self.accel, gbuf, light, jax.random.fold_in(key, li))
                     [0] for li, light in enumerate(self.lights)]
            jax.block_until_ready(masks)
        cp = jax.jit(lambda gbuf, mask, light: composite_pass(
            gbuf, mask, light, cfg.ambient, cfg.background))
        with timer.section("composite"):
            img = cp(gbuf, masks[0], self.lights[0])
            jax.block_until_ready(img)
        self.stats.gbuffer_ms = timer.ms["gbuffer"]
        self.stats.shadow_ms = timer.ms["shadow"]
        self.stats.composite_ms = timer.ms["composite"]

    # -- checkpoint / resume (SURVEY.md §5) ----------------------------------

    def save_state(self, path: str) -> None:
        """Checkpoint the temporal-accumulation state (config 3): resuming
        continues the running mean exactly."""
        from .checkpoint import save_accumulation
        accum = self.accum if self.accum is not None else \
            jnp.zeros((self.config.height, self.config.width, 3), jnp.float32)
        save_accumulation(path, accum, self.frame_index, self.config.seed)

    def load_state(self, path: str) -> None:
        from .checkpoint import load_accumulation
        accum, frame_index, seed = load_accumulation(path)
        assert seed == self.config.seed, (
            f"checkpoint seed {seed} != config seed {self.config.seed}")
        assert accum.shape == (self.config.height, self.config.width, 3)
        self.accum = jax.device_put(jnp.asarray(accum))
        self.frame_index = frame_index

    # -- io -----------------------------------------------------------------

    def save_png(self, path: str, out: Optional[Dict] = None) -> None:
        from .io.image import write_png
        if out is None:
            out = self.render_frame()
        write_png(path, np.asarray(out["image"]))
