"""Regenerate the golden images (run manually on CPU after INTENDED visual
changes; goldens are CPU-rendered and the suite forces CPU):

    env JAX_PLATFORMS=cpu python tests/gen_goldens.py
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from tpurt.io.image import to_uint8, write_png  # noqa: E402

HERE = os.path.join(os.path.dirname(__file__), "golden")


def golden_cases():
    """name -> callable() -> f32[H, W, 3]. Shared with test_golden.py so the
    goldens and the assertions can never drift apart."""
    from tpurt.app import Renderer
    from tpurt.scenes import (default_camera_for, deform,
                              sponza_interior_camera, sponza_scene,
                              teapot_scene)
    from tpurt.types import Light, RenderConfig

    def teapot(bvh_width=2):
        """bvh_width 2: binary XLA walk; 8: the 8-wide accel's XLA walk
        (the CUDA kernel's plain twin) — both land on the same golden."""
        mesh = teapot_scene(1500)
        r = Renderer(mesh, default_camera_for(mesh),
                     Light.directional((0.45, 0.8, 0.3)),
                     RenderConfig(width=128, height=96, use_kernel=False,
                                  bvh_width=bvh_width,
                                  leaf_size=8 if bvh_width == 8 else 4,
                                  seed=0))
        return np.asarray(r.render_frame()["image"])

    def sponza():
        """Sponza-class interior (config 2's scene family, scaled down for
        the CPU oracle path)."""
        mesh = sponza_scene(30_000)
        r = Renderer(mesh, sponza_interior_camera(),
                     Light.directional((0.25, 0.9, 0.2)),
                     RenderConfig(width=160, height=90, use_kernel=False, bvh_width=2,
                                  leaf_size=4, seed=0))
        return np.asarray(r.render_frame()["image"])

    def soft():
        """Area-light soft shadows, spp=4 (config 3 family)."""
        mesh = teapot_scene(1500)
        r = Renderer(mesh, default_camera_for(mesh),
                     Light.sun((0.45, 0.8, 0.3), angular_radius_deg=4.0),
                     RenderConfig(width=128, height=96, use_kernel=False, bvh_width=2,
                                  leaf_size=4, spp=4, seed=0))
        return np.asarray(r.render_frame()["image"])

    def multilight():
        """Two lights: directional + point (config 5 family)."""
        mesh = teapot_scene(1500)
        cam = default_camera_for(mesh)
        lights = [Light.directional((0.45, 0.8, 0.3),
                                    color=(1.0, 0.95, 0.85)),
                  Light.point(np.asarray(mesh.vertices).mean(0)
                              + np.float32([2.5, 3.0, -1.5]),
                              color=(0.4, 0.5, 1.0), intensity=0.8)]
        r = Renderer(mesh, cam, lights,
                     RenderConfig(width=128, height=96, use_kernel=False, bvh_width=2,
                                  leaf_size=4, seed=0))
        return np.asarray(r.render_frame()["image"])

    def refit():
        """Animated mesh through the refit fast path (config 4 family):
        two deformation steps, golden = the third frame."""
        mesh = teapot_scene(1500)
        r = Renderer(mesh, default_camera_for(mesh),
                     Light.directional((0.45, 0.8, 0.3)),
                     RenderConfig(width=128, height=96, use_kernel=False, bvh_width=2,
                                  leaf_size=4, seed=0),
                     mode="refit")
        out = r.render_frame()
        for step in (1, 2):
            r.set_vertices(deform(mesh, 0.35 * step))
            out = r.render_frame()
        return np.asarray(out["image"])

    return {
        "teapot_128x96": teapot,
        "sponza_160x90": sponza,
        "soft_spp4_128x96": soft,
        "multilight_128x96": multilight,
        "refit_128x96": refit,
    }


def main():
    for name, fn in golden_cases().items():
        if name == "teapot_128x96":
            continue  # round-1 golden: regenerate only on intended change
        img = fn()
        path = os.path.join(HERE, f"{name}.png")
        write_png(path, img)
        print(f"wrote {path} (mean {to_uint8(img).mean():.1f})")


if __name__ == "__main__":
    main()
