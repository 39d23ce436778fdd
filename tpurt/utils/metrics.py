"""Per-pass timing + throughput metrics.

The reference brackets each pass with GPU timestamp queries and draws
gbuffer/shadow/combine times on a HUD (Rush GfxContext timestamps [RECALL]).
Here: wall-clock brackets around ``block_until_ready`` at pass
boundaries (only meaningful in profile mode — in fused mode XLA runs the
whole frame as one program, which is the fast path), plus the BASELINE
headline metric Mrays/s = shadow rays / shadow-pass seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import jax


@dataclasses.dataclass
class FrameStats:
    """Structured per-frame stats (SURVEY.md §5 observability)."""

    width: int = 0
    height: int = 0
    spp: int = 1
    num_lights: int = 1
    rays_primary: int = 0
    rays_shadow: int = 0
    build_ms: float = 0.0
    refit_ms: float = 0.0
    gbuffer_ms: float = 0.0
    shadow_ms: float = 0.0
    composite_ms: float = 0.0
    frame_ms: float = 0.0
    mrays_per_s: float = 0.0
    mode: str = "static"

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    def hud(self) -> str:
        """One-line HUD string, the moral equivalent of the reference's
        on-screen text."""
        return (f"{self.width}x{self.height} spp={self.spp} "
                f"lights={self.num_lights} | build {self.build_ms:6.2f} ms | "
                f"gbuf {self.gbuffer_ms:6.2f} ms | shadow {self.shadow_ms:6.2f} ms | "
                f"combine {self.composite_ms:5.2f} ms | frame {self.frame_ms:7.2f} ms | "
                f"{self.mrays_per_s:8.1f} Mrays/s")


class Timer:
    """Wall-clock bracket that blocks on device results for honest timings."""

    def __init__(self):
        self.ms: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, *blockers):
        t0 = time.perf_counter()
        yield
        for b in blockers:
            jax.block_until_ready(b)
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def block(tree):
    jax.block_until_ready(tree)
    return tree


def mrays_per_s(num_rays: int, seconds: float) -> float:
    if seconds <= 0:
        return 0.0
    return num_rays / seconds / 1e6
