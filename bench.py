"""Benchmark: Sponza-class 1080p hard shadows on one NVIDIA GPU.

Measures the BASELINE.json headline metric — shadow-ray throughput
(Mrays/s per card) — plus full-frame ms (G-buffer + shadow + composite),
the per-frame LBVH rebuild and the rebuilt tree's own trace, from the
representative interior viewpoint. The extras time BASELINE configs 3
(soft shadows spp=8), 4 (clip-geometry refit) and 5 (4K, three lights).

Output: one JSON line on stdout after the headline block and, unless
``--headline-only``, a second, richer one after the extras. Every line
names the device (JAX's platform, device_kind and count) and the card's
name and power limit. Without a GPU it prints no result and exits 1.

Timing: every timed call ends in ``jax.block_until_ready``; each number
is the median of its repeats after one warm-up call (compilation is
excluded and reported by nothing here — chip_smoke.py reports it).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, reps: int) -> float:
    """Median seconds per call of ``fn`` (warm-up call excluded)."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def gb_consume(g):
    """Device-scalar reduction consuming EVERY G-buffer output the
    downstream passes read — a valid-only reduction would let XLA
    dead-code-eliminate the attribute gathers."""
    import jax.numpy as jnp
    return (jnp.sum(g["normal"]) + jnp.sum(g["albedo"])
            + jnp.sum(g["position"]) + jnp.sum(g["tri_id"])
            + jnp.sum(jnp.where(g["valid"], 1.0, 0.0)))


def bench_headline(width: int, height: int, tris: int, leaf_size: int):
    """Configs 1/2 + the static frame. Returns (result, ctx)."""
    import jax
    from tpurt.app import (_rebuild_fused, gbuffer_production, make_tracers,
                           render_frame_fn)
    from tpurt.bvh.lbvh import auto_split_blocks, build_lbvh
    from tpurt.bvh.sah import build_sah_lbvh
    from tpurt.bvh.wide import build_wide
    from tpurt.kernels.traverse import build_library
    from tpurt.native import ensure_native
    from tpurt.passes.shading import make_shade_table
    from tpurt.passes.shadow import shadow_ray_batch
    from tpurt.scenes import sponza_interior_camera, sponza_scene
    from tpurt.types import Light, RenderConfig

    result = {"cuda_build_s": round(build_library(), 2)}
    t0 = time.perf_counter()
    ensure_native()
    result["native_compile_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    cfg = RenderConfig(width=width, height=height, leaf_size=leaf_size)
    host_mesh = sponza_scene(tris)
    mesh = jax.device_put(host_mesh)
    cam = sponza_interior_camera()
    light = Light.directional((0.25, 0.9, 0.2))
    log(f"scene tris={mesh.num_triangles} {width}x{height} leaf={leaf_size}")

    # Static-scene accel: native host SBVH (the reference's own startup
    # strategy), widened to the 8-wide rows the kernel walks.
    t0 = time.perf_counter()
    static_bvh = build_sah_lbvh(host_mesh, leaf_size)
    if static_bvh is None:
        raise RuntimeError("native SAH library unavailable")
    result["sah_host_build_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    static_bvh = jax.device_put(static_bvh)
    static_accel = build_wide(static_bvh, from_node_boxes=True)
    st0 = jax.jit(make_shade_table)(static_bvh, mesh)
    _, trace_any = make_tracers(cfg)

    gb = jax.jit(lambda a, m, c, st: gbuffer_production(
        a, m, c, cfg, shade_table=st))
    gbuf = gb(static_accel, mesh, cam, st0)
    gbuf.pop("trace_errors")
    valid = int(np.asarray(gbuf["valid"]).sum())
    log(f"gbuffer valid px: {valid}/{width * height}")
    gb_scalar = jax.jit(lambda a, m, c, st: gb_consume(gb(a, m, c, st)))
    result["gbuffer_ms"] = timed(
        lambda: gb_scalar(static_accel, mesh, cam, st0), 20) * 1e3

    so, sd, stm = jax.jit(lambda g, l, b: shadow_ray_batch(
        g, l, cfg.shadow_bias, None,
        scene_bounds=(b.root_min, b.root_max)))(gbuf, light, static_bvh)
    shade = jax.jit(lambda a, o, d, tm: trace_any(a, o, d, tm))
    shadow_s = timed(lambda: shade(static_accel, so, sd, stm), 40)
    result["shadow_ms"] = shadow_s * 1e3
    result["mrays"] = valid / shadow_s / 1e6
    log(f"shadow trace: {shadow_s * 1e3:.3f} ms -> {result['mrays']:.1f} "
        f"Mrays/s")

    # Config 2: the on-device LBVH, its fused per-frame rebuild (build +
    # fixed-cut collapse + shading table, tpurt/app.py _rebuild_fused) and
    # the rebuilt tree's own trace.
    build = jax.jit(lambda v, i: build_lbvh(v, i, leaf_size=leaf_size))
    result["build_ms"] = timed(
        lambda: build(mesh.vertices, mesh.indices).nodes_box, 20) * 1e3
    msp = auto_split_blocks(mesh.num_triangles, leaf_size)
    w0 = build_wide(jax.jit(functools.partial(
        build_lbvh, leaf_size=leaf_size, split_blocks=msp))(
            mesh.vertices, mesh.indices), mode="fixed")
    reb = jax.jit(functools.partial(
        _rebuild_fused, leaf_size=leaf_size, nw_pad=w0.num_wide,
        stack_depth=w0.stack_depth, split_blocks=msp))
    rebuild_s = timed(lambda: reb(mesh.vertices, mesh.indices,
                                  mesh)[1].nodes, 10)
    acc = reb(mesh.vertices, mesh.indices, mesh)[1]
    trace_s = timed(lambda: shade(acc, so, sd, stm), 20)
    result["rebuild_ms"] = rebuild_s * 1e3
    result["rebuilt_tree_shadow_ms"] = trace_s * 1e3
    result["build_plus_trace_same_tree_ms"] = (rebuild_s + trace_s) * 1e3
    log(f"rebuild (M={msp}): {rebuild_s * 1e3:.3f} ms + own-tree trace "
        f"{trace_s * 1e3:.3f} ms")

    frame = jax.jit(lambda a, m, c, lights, key, st: render_frame_fn(
        a, m, c, lights, key, cfg, shade_table=st)["image"])
    key = jax.random.PRNGKey(0)
    result["frame_ms"] = timed(lambda: frame(static_accel, mesh, cam,
                                             (light,), key, st0), 20) * 1e3
    log(f"frame (gbuffer+shadow+composite): {result['frame_ms']:.3f} ms")
    ctx = dict(mesh=mesh, cam=cam, gbuf=gbuf, trace_any=trace_any,
               static_bvh=static_bvh, static_accel=static_accel, st0=st0,
               valid=valid, leaf_size=leaf_size)
    return result, ctx


def bench_extras(ctx) -> dict:
    """BASELINE configs 3 (soft spp=8), 4 (clip refit), 5 (4K, 3 lights)."""
    import jax
    from tpurt.app import render_frame_fn
    from tpurt.bvh.clip_refit import make_clip_refit, refit_sbvh_wide
    from tpurt.cli import build_lights
    from tpurt.passes.shadow import shadow_pass
    from tpurt.types import Light, RenderConfig
    mesh, cam, gbuf = ctx["mesh"], ctx["cam"], ctx["gbuf"]
    accel, bvh, st0 = ctx["static_accel"], ctx["static_bvh"], ctx["st0"]
    trace_any = ctx["trace_any"]
    out = {}

    sun = Light.sun((0.25, 0.9, 0.2), angular_radius_deg=2.5)
    sp8 = jax.jit(lambda a, g, k: shadow_pass(
        lambda o, d, tm: trace_any(a, o, d, tm), g, sun, 8, k, 1e-3,
        scene_bounds=(a.root_min, a.root_max)))
    t = timed(lambda: sp8(accel, gbuf, jax.random.PRNGKey(1)), 10)
    out["soft_spp8_ms"] = t * 1e3
    out["soft_spp8_mrays"] = ctx["valid"] * 8 / t / 1e6
    log(f"config 3 soft spp=8: {out['soft_spp8_ms']:.3f} ms")

    cplan = jax.device_put(make_clip_refit(bvh, accel.num_wide))
    crefit = jax.jit(lambda b, v: refit_sbvh_wide(
        cplan, b, None, None, None, vertices=v)[0].nodes)
    out["refit_ms"] = timed(lambda: crefit(bvh, mesh.vertices), 20) * 1e3
    log(f"config 4 clip refit: {out['refit_ms']:.3f} ms")

    cfg5 = RenderConfig(width=3840, height=2160,
                        leaf_size=ctx["leaf_size"])
    lights = tuple(build_lights("multi", (0.45, 0.8, 0.3)))
    frame5 = jax.jit(lambda a, m, c, l, k, st: render_frame_fn(
        a, m, c, l, k, cfg5, shade_table=st)["image"])
    key = jax.random.PRNGKey(0)
    out["frame_4k_3light_ms"] = timed(
        lambda: frame5(accel, mesh, cam, lights, key, st0), 10) * 1e3
    log(f"config 5 4K 3-light frame: {out['frame_4k_3light_ms']:.3f} ms")
    return out


def _device_info() -> dict:
    import jax
    devs = jax.devices()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card.splitlines()[0] if card else ""}


def _payload(result: dict, device: dict, extras_complete: bool) -> dict:
    rounded = {k: (round(v, 3) if isinstance(v, float) else v)
               for k, v in result.items() if k != "mrays"}
    return {"metric": "shadow_mrays_per_s",
            "value": round(result["mrays"], 2), "unit": "Mrays/s",
            "device": device,
            "sponza1080p_build_plus_trace_ms": rounded.pop(
                "build_plus_trace_same_tree_ms"),
            **rounded, "extras_complete": extras_complete}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--headline-only", action="store_true",
                    help="stop after the headline block")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import jax
    from tpurt.compile_cache import enable_compile_cache
    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        log(f"bench.py needs an NVIDIA GPU; JAX runs on "
            f"{jax.devices()[0].platform}")
        return 1
    device = _device_info()
    log(f"device: {device}")
    result, ctx = bench_headline(1920, 1080, 260_000, 14)
    print(json.dumps(_payload(result, device, False)), flush=True)
    if not args.headline_only:
        result.update(bench_extras(ctx))
        print(json.dumps(_payload(result, device, True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
