#!/usr/bin/env python3
"""Chip smoke test: drive the renderer's main path once on an NVIDIA GPU.

    python chip_smoke.py          one card: phases 1-6 below
    python chip_smoke.py --four   four cards: the row-sharded 4K frame and
                                  its one-card comparison, nothing else

Phases (one process: a JAX process reserves most of the card's memory, so
the GPU-marked tests run here through pytest.main, not as a child):

1. Device: JAX's view of the card, and its name and power limit from
   nvidia-smi (a child process that stays off JAX). Fails off a GPU.
2. Build and compile: the CUDA library (set-up time), the Sponza-class
   SBVH accel, both kernels compiled at 1080p, and the frame step's
   memory analysis.
3. Kernel against reference: closest and any hit at 1080p against the
   plain XLA walk of the same 8-wide accel.
4. Main path: presets config1-config5 (tpurt/cli.py) through Renderer,
   3 frames each, timed, each image compared with the plain-XLA route's.
5. Kernel or XLA: the static 1080p frame and its shadow pass timed three
   ways, in turns — the decision for keeping the kernel.
6. The GPU-marked tests (tests/test_gpu.py).

Every timing line carries the card's name and power limit. Any failure
raises and exits non-zero; the last line of a passing run is one JSON
object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SPONZA_TRIS = 260_000
LEAF_SIZE = 14
# Phase-3 tolerances. Ties on shared edges may pick either triangle, and
# float32 rounding differs between nvcc's code and XLA's, so ids may
# disagree on a few pixels and t in the last digits. Everything is
# float32 and traversal does no matrix products (no TF32 anywhere).
ID_AGREE_MIN = 0.9999        # tri_id equal on valid pixels
T_REL_MAX = 1e-5             # |t_kernel - t_xla| / t_xla where ids agree
OCC_DIFF_MAX = 1e-4          # share of shadow rays whose occlusion differs
SHARD_IMAGE_TOL = 1e-5       # --four: sharded vs one-card image


def card_lines() -> list:
    """nvidia-smi name and power limit per card (a child off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [l.strip() for l in out.stdout.splitlines() if l.strip()]


class Report:
    """Prints phase headers and timing lines tagged with the card."""

    def __init__(self, card: str):
        self.card = card

    def phase(self, title: str) -> None:
        print(f"\n=== {title}", flush=True)

    def timing(self, msg: str) -> None:
        print(f"{msg}  [{self.card}]", flush=True)


def _median_ms(fn, repeats: int) -> float:
    import numpy as np
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def sponza_accel():
    """Sponza-class scene + native SBVH + 8-wide rows (Renderer's static
    path, without the Renderer)."""
    import jax
    from tpurt.bvh.sah import build_sah_lbvh
    from tpurt.bvh.wide import build_wide
    from tpurt.passes.shading import make_shade_table
    from tpurt.scenes import sponza_scene
    mesh = jax.device_put(sponza_scene(SPONZA_TRIS))
    bvh = jax.device_put(build_sah_lbvh(mesh, LEAF_SIZE))
    wide = build_wide(bvh, from_node_boxes=True)
    return mesh, bvh, wide, make_shade_table(bvh, mesh)


def phase_build(rep: Report, mesh, wide, st, cam):
    import jax
    from tpurt.app import render_frame_fn
    from tpurt.camera import generate_rays
    from tpurt.cli import build_lights
    from tpurt.kernels.traverse import trace_any_cuda, trace_closest_cuda
    from tpurt.bvh.wide import wide_levels_device
    from tpurt.types import RenderConfig
    rep.timing(f"accel: {mesh.num_triangles} tris, nodes {wide.nodes.shape}, "
               f"leaf rows {wide.tris.shape}, "
               f"{(wide.nodes.size + wide.tris.size) * 4 / 1e6:.1f} MB, "
               f"{int(wide_levels_device(wide.nodes))} wide levels, "
               f"{wide.stack_depth}-entry walk stack")
    o, d = generate_rays(cam, 1920, 1080)
    for name, fn, args in (
            ("closest", trace_closest_cuda, (wide, o, d)),
            ("any", trace_any_cuda, (wide, o, d, 3.4e38))):
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        rep.timing(f"compiled {name}-hit kernel at 1080p in "
                   f"{time.perf_counter() - t0:.2f} s: "
                   f"{compiled.memory_analysis()}")
    cfg = RenderConfig(width=1920, height=1080, leaf_size=LEAF_SIZE)
    lights = tuple(build_lights("directional", (0.45, 0.8, 0.3)))
    t0 = time.perf_counter()
    compiled = render_frame_fn.lower(wide, mesh, cam, lights,
                                     jax.random.PRNGKey(0), cfg,
                                     shade_table=st).compile()
    rep.timing(f"compiled the static 1080p frame step in "
               f"{time.perf_counter() - t0:.2f} s")
    print(f"frame step memory_analysis: {compiled.memory_analysis()}")


def phase_reference(rep: Report, wide, cam):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tpurt.bvh.traverse import traverse_wide
    from tpurt.camera import generate_rays
    from tpurt.kernels.traverse import trace_any_cuda, trace_closest_cuda
    o, d = generate_rays(cam, 1920, 1080)
    tk, sk, ek = jax.jit(trace_closest_cuda)(wide, o, d)
    with jax.default_matmul_precision("highest"):
        tx, sx, ex = jax.jit(traverse_wide)(wide, o, d)
    tid = np.asarray(wide.tri_id)
    sk, sx = np.asarray(sk), np.asarray(sx)
    ik = np.where(sk >= 0, tid[np.maximum(sk, 0)], -1)
    ix = np.where(sx >= 0, tid[np.maximum(sx, 0)], -1)
    valid = (ix >= 0) | (ik >= 0)
    agree = float((ik == ix)[valid].mean())
    same = (ik == ix) & (ix >= 0)
    tk, tx = np.asarray(tk), np.asarray(tx)
    rel = np.abs(tk[same] - tx[same]) / np.abs(tx[same])
    t_rel = float(rel.max()) if rel.size else 0.0
    print(f"closest hit, 1080p: tri_id agreement {agree:.6f} on "
          f"{int(valid.sum())} valid pixels (need >= {ID_AGREE_MIN}); "
          f"max t relative error {t_rel:.3g} (need <= {T_REL_MAX}); "
          f"walk errors kernel {int(ek)} / XLA {int(ex)}")
    # Shadow rays toward the sun from the reference hits.
    ldir = jnp.asarray([0.45, 0.8, 0.3]) / np.linalg.norm([0.45, 0.8, 0.3])
    hit = jnp.asarray(ix >= 0)
    so = o + d * jnp.where(hit, jnp.asarray(tx), 0.0)[..., None] + 1e-3 * ldir
    sd = jnp.broadcast_to(ldir, so.shape)
    tm = jnp.where(hit, 3.4e38, 0.0)
    occ_k, eak = jax.jit(trace_any_cuda)(wide, so, sd, tm)
    with jax.default_matmul_precision("highest"):
        _, sax, eax = jax.jit(
            lambda w, o, d, t: traverse_wide(w, o, d, t_max=t,
                                             any_hit=True))(wide, so, sd, tm)
    occ_diff = float(np.mean(np.asarray(occ_k) != (np.asarray(sax) >= 0)))
    print(f"any hit, 1080p: occlusion differs on {occ_diff:.3g} of rays "
          f"(need <= {OCC_DIFF_MAX}); walk errors kernel {int(eak)} / XLA "
          f"{int(eax)}")
    ok = (agree >= ID_AGREE_MIN and t_rel <= T_REL_MAX
          and occ_diff <= OCC_DIFF_MAX
          and int(ek) == int(ex) == int(eak) == int(eax) == 0)
    if not ok:
        raise AssertionError("kernel disagrees with the XLA walk beyond the "
                             "stated tolerances")


def _preset_renderer(preset: str, use_kernel: bool):
    """Renderer for a cli.PRESETS entry, built as tpurt.cli.main builds it
    (teapot for config1, Sponza-class for configs 2-5)."""
    from tpurt.app import Renderer
    from tpurt.cli import PRESETS, build_lights, build_scene
    from tpurt.scenes import default_camera_for, sponza_interior_camera
    from tpurt.types import RenderConfig
    opts = PRESETS[preset]
    scene = "teapot" if preset == "config1" else "sponza"
    mesh = build_scene(scene)
    cam = (sponza_interior_camera() if scene == "sponza"
           else default_camera_for(mesh))
    lights = build_lights(opts["lights"], (0.45, 0.8, 0.3), mesh=mesh)
    cfg = RenderConfig(width=opts["width"], height=opts["height"],
                       spp=opts["spp"], use_kernel=use_kernel,
                       accumulate=opts.get("accumulate", False),
                       leaf_size=LEAF_SIZE)
    r = Renderer(mesh, cam, lights, cfg, mode=opts["mode"])
    return r, mesh, opts


def _render_frames(r, mesh, opts, frames: int = 3):
    """Render ``frames`` frames as the CLI loop does; returns (last image
    as numpy, per-frame wall ms)."""
    import numpy as np
    from tpurt.scenes import deform
    times = []
    out = None
    for f in range(frames):
        if opts.get("animate"):
            r.set_vertices(deform(mesh, time=f * 0.08))
        t0 = time.perf_counter()
        out = r.render_frame()
        img = np.asarray(out["image"])
        times.append((time.perf_counter() - t0) * 1e3)
    return img, times


def _accel_line(r) -> str:
    """Which accel a Renderer built, with its depth and walk stack."""
    from tpurt.bvh.wide import wide_levels_device
    levels = int(wide_levels_device(r.accel.nodes))
    return (f"{r.accel_kind}; {levels} wide levels, "
            f"{r.accel.stack_depth}-entry stack")


def phase_presets(rep: Report):
    import gc
    import numpy as np
    expect = {"config1": "native host SBVH", "config2": "on-device Morton",
              "config3": "native host SBVH", "config4": "native host SBVH",
              "config5": "native host SBVH"}
    for preset in ("config1", "config2", "config3", "config4", "config5"):
        r, mesh, opts = _preset_renderer(preset, True)
        kind = r.accel_kind
        if not kind.startswith(expect[preset]) or "CUDA" not in kind:
            raise AssertionError(f"{preset} built {kind!r}")
        accel = _accel_line(r)
        img_k, times = _render_frames(r, mesh, opts)
        del r
        gc.collect()
        rp, mesh, opts = _preset_renderer(preset, False)
        img_x, _ = _render_frames(rp, mesh, opts)
        del rp
        gc.collect()
        diff = np.abs(img_k - img_x)
        rep.timing(
            f"{preset} ({opts['width']}x{opts['height']} {opts['mode']} "
            f"spp={opts['spp']} lights={opts['lights']}; {accel}): "
            f"ms/frame first {times[0]:.2f} (compiles), then "
            f"{times[1]:.3f} {times[2]:.3f}; vs plain route: max |d| "
            f"{diff.max():.3g}, pixels off > 1e-3: "
            f"{float((diff.max(axis=-1) > 1e-3).mean()):.3g}")
        if not np.isfinite(img_k).all():
            raise AssertionError(f"{preset}: non-finite pixels")


def phase_decide(rep: Report, mesh, bvh_sah, wide, st, cam):
    """Frame and shadow pass, three ways, in turns (kernel, XLA, XLA,
    kernel for the first two; the binary route once between)."""
    import jax
    from tpurt.app import render_frame_fn, shadow_production, \
        gbuffer_production
    from tpurt.bvh.lbvh import build_lbvh
    from tpurt.cli import build_lights
    from tpurt.passes.shading import make_shade_table
    from tpurt.types import RenderConfig
    lights = tuple(build_lights("directional", (0.45, 0.8, 0.3)))
    key = jax.random.PRNGKey(0)
    binary = jax.jit(lambda m: build_lbvh(m.vertices, m.indices,
                                          leaf_size=4))(mesh)
    st_b = make_shade_table(binary, mesh)
    routes = {
        "kernel": (RenderConfig(width=1920, height=1080,
                                leaf_size=LEAF_SIZE), wide, st),
        "xla-wide": (RenderConfig(width=1920, height=1080,
                                  leaf_size=LEAF_SIZE, use_kernel=False),
                     wide, st),
        "xla-binary": (RenderConfig(width=1920, height=1080, leaf_size=4,
                                    use_kernel=False, bvh_width=2),
                       binary, st_b),
    }
    steps = {}
    for name, (cfg, accel, table) in routes.items():
        gbuf = jax.jit(gbuffer_production, static_argnames=("cfg",))(
            accel, mesh, cam, cfg, shade_table=table)
        gbuf.pop("trace_errors")
        shadow = jax.jit(shadow_production, static_argnames=("cfg",))

        def frame(cfg=cfg, accel=accel, table=table):
            jax.block_until_ready(render_frame_fn(
                accel, mesh, cam, lights, key, cfg,
                shade_table=table)["image"])

        def shade(cfg=cfg, accel=accel, gbuf=gbuf, shadow=shadow):
            jax.block_until_ready(shadow(accel, gbuf, lights[0], key, cfg))
        frame()
        shade()                          # compile outside the timing
        steps[name] = (frame, shade)
    order = ["kernel", "xla-wide", "xla-binary", "xla-wide", "kernel"]
    res = {n: {"frame": [], "shadow": []} for n in routes}
    for name in order:
        frame, shade = steps[name]
        reps = 5 if name == "kernel" else 2
        res[name]["frame"].append(_median_ms(frame, reps))
        res[name]["shadow"].append(_median_ms(shade, reps))
    for name in routes:
        rep.timing(f"static Sponza 1080p, 1 sun, {name}: frame ms "
                   f"{res[name]['frame']}, shadow pass ms "
                   f"{res[name]['shadow']}")
    best = {n: min(v["frame"]) for n, v in res.items()}
    keep = best["kernel"] < min(best["xla-wide"], best["xla-binary"])
    print(f"decision: the CUDA kernel {'stays' if keep else 'goes'} "
          f"(best frame ms kernel {best['kernel']:.3f}, XLA wide "
          f"{best['xla-wide']:.3f}, XLA binary {best['xla-binary']:.3f})")


def phase_tests():
    import pytest
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"GPU-marked tests failed (pytest exit {rc})")


def run_four(rep: Report):
    """Row-sharded static Sponza 4K two-light frame over 4 cards, on the
    CLI's --shard path (parallel/tiling.sharded_frames), vs the same
    Renderer's frame on one card."""
    import jax
    import numpy as np
    from tpurt.app import Renderer, check_trace_errors
    from tpurt.cli import build_lights, build_scene
    from tpurt.parallel.tiling import sharded_frames
    from tpurt.scenes import sponza_interior_camera
    from tpurt.types import RenderConfig
    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX sees {len(devs)}")
    lights = build_lights("multi", (0.45, 0.8, 0.3))[:2]
    r = Renderer(build_scene("sponza"), sponza_interior_camera(), lights,
                 RenderConfig(width=3840, height=2160, leaf_size=LEAF_SIZE))
    print(f"accel: {_accel_line(r)}")
    shard_frame = sharded_frames(r, devs[:4])
    key = jax.random.PRNGKey(r.config.seed)

    def one():
        return r.render_frame()["image"]

    def four():
        img, errors = shard_frame(key)
        check_trace_errors(errors, "sharded frame")
        return jax.block_until_ready(img)

    img1, img4 = np.asarray(one()), np.asarray(four())
    # In turns: one card, four, four, one; each as its user path runs it
    # (Renderer.render_frame; the CLI's --shard frame and error check).
    t1, t4 = [_median_ms(one, 5)], []
    t4 += [_median_ms(four, 5), _median_ms(four, 5)]
    t1.append(_median_ms(one, 5))
    rep.timing(f"static Sponza 4K, 2 suns, one card (Renderer): frame ms "
               f"{t1}")
    rep.timing(f"static Sponza 4K, 2 suns, rows sharded over 4 cards "
               f"(--shard path): frame ms {t4}")
    d = np.abs(img1 - img4).max(axis=-1)
    diff = float(d.max())
    print(f"sharded vs one-card image: max |d| {diff:.3g} (need <= "
          f"{SHARD_IMAGE_TOL}), {int((d > SHARD_IMAGE_TOL).sum())} pixels "
          f"over")
    if diff > SHARD_IMAGE_TOL:
        raise AssertionError("sharded frame disagrees with one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded frame and its "
                         "one-card comparison")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(REPO, "tpurt")):
        print("chip_smoke: the tpurt package is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import jax
    from tpurt.compile_cache import enable_compile_cache
    cache = enable_compile_cache()

    devs = jax.devices()
    dev = devs[0]
    print(f"jax {jax.__version__}: devices {devs}; platform {dev.platform}, "
          f"device_kind {dev.device_kind}, count {len(devs)}; compile cache "
          f"{cache}")
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    cards = card_lines()
    for line in cards:
        print(f"card: {line}")
    rep = Report(cards[0])

    if args.four:
        rep.phase("four cards: sharded 4K frame vs one card")
        run_four(rep)
    else:
        from tpurt.kernels.traverse import build_library
        from tpurt.scenes import sponza_interior_camera
        rep.phase("phase 2: build and compile")
        rep.timing(f"set-up: CUDA library built in {build_library():.2f} s")
        t0 = time.perf_counter()
        mesh, bvh, wide, st = sponza_accel()
        rep.timing(f"set-up: Sponza-class scene + SBVH + 8-wide rows in "
                   f"{time.perf_counter() - t0:.2f} s")
        cam = sponza_interior_camera()
        phase_build(rep, mesh, wide, st, cam)
        rep.phase("phase 3: kernel against the XLA walk of the same accel")
        phase_reference(rep, wide, cam)
        rep.phase("phase 4: presets config1-config5, kernel vs plain route")
        phase_presets(rep)
        rep.phase("phase 5: kernel or XLA (static Sponza 1080p)")
        phase_decide(rep, mesh, bvh, wide, st, cam)
        rep.phase("phase 6: GPU-marked tests")
        phase_tests()

    for line in cards:
        print(f"card: {line}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
