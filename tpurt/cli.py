"""Command-line interface.

The reference is launched as ``RayTracedShadows <scene.obj>`` with an
interactive window (Source/RayTracedShadows.cpp ``main`` -> Rush
``Platform_Main`` [RECALL]); this headless equivalent renders N frames and
writes PNGs, with every BASELINE.json benchmark config expressible as a
preset:

    python -m tpurt.cli --scene teapot  --preset config1 --out out.png
    python -m tpurt.cli --scene sponza  --preset config2 --frames 10
    python -m tpurt.cli --scene bunny.obj --width 1280 --height 720 ...
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .types import Light, RenderConfig

PRESETS = {
    # BASELINE.json configs 1-5.
    "config1": dict(width=512, height=512, spp=1, mode="static",
                    lights="directional"),
    "config2": dict(width=1920, height=1080, spp=1, mode="rebuild",
                    lights="directional"),
    "config3": dict(width=1920, height=1080, spp=8, mode="static",
                    lights="sun", accumulate=True),
    "config4": dict(width=1920, height=1080, spp=1, mode="refit",
                    lights="directional", animate=True),
    # sort_rays off: primary-derived shadow rays are already coherent in
    # pixel order; --sort-rays remains available.
    "config5": dict(width=3840, height=2160, spp=1, mode="static",
                    lights="multi"),
}


def build_scene(name: str):
    from . import scenes
    from .io.obj import load_obj
    if name == "teapot":
        return scenes.teapot_scene()
    if name == "sponza":
        return scenes.sponza_scene()
    if name.startswith("soup"):
        n = int(name[4:] or "1000")
        return scenes.random_soup(n)
    return load_obj(name)


def build_lights(kind: str, direction, mesh=None, position=None,
                 radius=0.0):
    if kind == "directional":
        return [Light.directional(direction)]
    if kind == "sun":
        return [Light.sun(direction, angular_radius_deg=2.0)]
    if kind == "point":
        import numpy as np
        if position is None:
            # Above the scene center along the light direction, half a
            # scene diagonal away — a sensible interior-lamp default.
            v = np.asarray(mesh.vertices)
            lo, hi = v.min(0), v.max(0)
            diag = float(np.linalg.norm(hi - lo))
            d = np.asarray(direction, np.float32)
            d = d / max(float(np.linalg.norm(d)), 1e-9)
            position = 0.5 * (lo + hi) + d * (0.5 * diag)
        return [Light.point(position, radius=radius)]
    if kind == "multi":
        return [Light.directional(direction, intensity=0.8),
                Light.directional((-0.55, 0.65, 0.25), color=(1.0, 0.85, 0.6),
                                  intensity=0.5),
                Light.directional((0.1, 0.9, -0.4), color=(0.7, 0.8, 1.0),
                                  intensity=0.35)]
    raise ValueError(kind)


def main(argv=None) -> int:
    from .compile_cache import enable_compile_cache
    enable_compile_cache()
    p = argparse.ArgumentParser(prog="tpurt",
                                description="ray-traced shadows in JAX")
    p.add_argument("--scene", default="teapot",
                   help="teapot | sponza | soup<N> | path/to/model.obj")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="BASELINE benchmark config preset")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--mode", choices=("static", "rebuild", "refit"),
                   default=None)
    p.add_argument("--light", choices=("directional", "sun", "point",
                                       "multi"),
                   default=None)
    p.add_argument("--light-dir", type=float, nargs=3,
                   default=(0.45, 0.8, 0.3))
    p.add_argument("--light-pos", type=float, nargs=3, default=None,
                   help="point-light position (default: above the scene "
                        "center along --light-dir)")
    p.add_argument("--light-radius", type=float, default=0.0,
                   help="point-light source radius; with --spp > 1 the "
                        "penumbra is disk-sampled")
    p.add_argument("--ambient", type=float, default=0.08)
    p.add_argument("--no-kernel", action="store_true",
                   help="walk the accel in plain XLA instead of the CUDA "
                        "kernel (the route for runs without an NVIDIA GPU)")
    p.add_argument("--sort-rays", action="store_true")
    p.add_argument("--accumulate", action="store_true")
    p.add_argument("--animate", action="store_true",
                   help="deform the mesh every frame (exercises refit)")
    p.add_argument("--orbit", type=float, default=None, metavar="DEG",
                   help="rotate the camera DEG degrees around its up axis "
                        "each frame (headless flythrough — the reference's "
                        "interactive fly-camera analogue)")
    p.add_argument("--leaf-size", type=int, default=None)
    p.add_argument("--out", default=None, help="output PNG path")
    p.add_argument("--profile", action="store_true",
                   help="collect per-pass timings (reference HUD analogue)")
    p.add_argument("--stats-json", action="store_true",
                   help="print per-frame stats as JSON lines")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-dir", default=None,
                   help="content-addressed LBVH cache directory")
    p.add_argument("--debug", action="store_true",
                   help="enable jax checks + NaN debugging + a checkified "
                        "traversal probe (the sanitizer mode; SURVEY.md "
                        "§5)")
    p.add_argument("--xprof", default=None, metavar="DIR",
                   help="write a kernel-level jax.profiler trace "
                        "(xprof/TensorBoard format) around the frame loop")
    p.add_argument("--rebuild-splits", type=int, default=-1,
                   help="rebuild mode: sub-leaf clustering — split the "
                        "top-M triangle blocks at their largest internal "
                        "Morton jump into two tight-boxed tree-leaves "
                        "(bvh/lbvh._subleaf_split). 0 = off, -1 = auto, "
                        "> 0 = exact M")
    p.add_argument("--no-sah", action="store_true",
                   help="skip the native host SAH build for static "
                        "scenes (use the on-device Morton LBVH)")
    p.add_argument("--shard", type=int, default=0, metavar="N",
                   help="shard image rows over the first N jax devices "
                        "(jax.sharding.Mesh axis 'tiles' — the SURVEY "
                        "§2.4 data-parallel path; static mode only). "
                        "Rehearse on virtual devices via JAX_PLATFORMS=cpu "
                        "XLA_FLAGS=--xla_force_host_platform_device_"
                        "count=8 and --no-kernel")
    args = p.parse_args(argv)

    if args.debug:
        import jax
        jax.config.update("jax_debug_nans", True)
        jax.config.update("jax_enable_checks", True)

    # Precedence: explicit flag > preset > default.
    defaults = dict(width=512, height=512, spp=1, mode="static",
                    lights="directional", accumulate=False, animate=False,
                    sort_rays=False)
    opts = dict(defaults)
    if args.preset:
        opts.update(PRESETS[args.preset])
    explicit = dict(width=args.width, height=args.height, spp=args.spp,
                    mode=args.mode, lights=args.light,
                    accumulate=args.accumulate or None,
                    animate=args.animate or None,
                    sort_rays=args.sort_rays or None)
    opts.update({k: v for k, v in explicit.items() if v is not None})

    mesh = build_scene(args.scene)
    from .scenes import default_camera_for, deform, sponza_interior_camera
    cam = (sponza_interior_camera() if args.scene == "sponza"
           else default_camera_for(mesh))
    lights = build_lights(opts["lights"], args.light_dir, mesh=mesh,
                          position=args.light_pos,
                          radius=args.light_radius)
    # Default leaf size 14: one leaf fills a whole 128-float leaf row of
    # the 8-wide accel (14 triangles x 9 floats).
    leaf_size = args.leaf_size if args.leaf_size is not None else 14
    cfg = RenderConfig(width=opts["width"], height=opts["height"],
                       spp=opts["spp"], ambient=args.ambient,
                       use_kernel=not args.no_kernel,
                       sort_rays=opts.get("sort_rays", False),
                       accumulate=opts.get("accumulate", False),
                       leaf_size=leaf_size, seed=args.seed,
                       sah=not args.no_sah,
                       rebuild_splits=args.rebuild_splits)

    from .app import Renderer
    r = Renderer(mesh, cam, lights, cfg, mode=opts["mode"],
                 cache_dir=args.cache_dir)
    print(f"scene={args.scene} tris={mesh.num_triangles} "
          f"{cfg.width}x{cfg.height} spp={cfg.spp} lights={len(lights)} "
          f"mode={opts['mode']} kernel={cfg.use_kernel}", file=sys.stderr)

    if args.debug:
        # Checkified traversal probe: assertions (NaNs, triangle-index
        # range, t-range) discharged on a small sample before rendering.
        from .camera import generate_rays
        from .utils.debug import checked_traverse
        o, d = generate_rays(cam, 32, 32)
        err, _ = checked_traverse(r.bvh, o, d)
        err.throw()
        print("debug: checkified traversal probe passed", file=sys.stderr)

    import contextlib
    if args.xprof:
        from .utils.debug import profile_trace
        trace_ctx = profile_trace(args.xprof)
    else:
        trace_ctx = contextlib.nullcontext()

    shard_frame = None
    if args.shard and args.shard > 1:
        if opts["mode"] != "static" or opts.get("animate") \
                or args.orbit is not None:
            p.error("--shard supports static scenes only (the per-frame "
                    "rebuild/refit/camera-path loops are single-chip; see "
                    "tpurt/parallel/tiling.py)")
        import jax

        from .parallel.tiling import sharded_frames
        devs = jax.devices()
        if len(devs) < args.shard:
            p.error(f"--shard {args.shard} but only {len(devs)} devices "
                    f"visible ({devs[0].platform})")
        shard_frame = sharded_frames(r, devs[:args.shard])
        print(f"sharding rows over {args.shard} devices "
              f"({devs[0].platform})", file=sys.stderr)

    out = None
    with trace_ctx:
        for f in range(args.frames):
            if shard_frame is not None:
                import jax
                img, errors = shard_frame(jax.random.fold_in(
                    jax.random.PRNGKey(cfg.seed), f))
                from .app import check_trace_errors
                check_trace_errors(errors, f"sharded frame {f}")
                out = {"image": img}
                continue
            if opts.get("animate"):
                r.set_vertices(deform(mesh, time=f * 0.08))
            if args.orbit is not None and f:
                from .camera import orbit
                r.set_camera(orbit(r.camera, np.deg2rad(args.orbit)))
            out = r.render_frame(profile=args.profile)
            if args.stats_json:
                print(json.dumps(r.stats.as_dict()))
            else:
                print(r.stats.hud(), file=sys.stderr)
    if args.xprof:
        print(f"xprof trace written to {args.xprof}", file=sys.stderr)

    if args.out and out is not None:
        from .io.image import write_png
        write_png(args.out, np.asarray(out["image"]))
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
