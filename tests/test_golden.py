"""Golden-image regression tests (SURVEY.md §4.4): whole-pipeline drift
detection against checked-in CPU reference renders, one per BASELINE config
family — hard shadows (binary and 8-wide walks), Sponza-class
interior, area-light soft shadows, multi-light, and animated refit.

Regenerate after INTENDED visual changes: python tests/gen_goldens.py.
"""

import os

import numpy as np
import pytest

from tpurt.io.image import read_png, to_uint8

from gen_goldens import golden_cases

pytestmark = pytest.mark.slow  # compile-heavy: full-suite tier only

HERE = os.path.join(os.path.dirname(__file__), "golden")
CASES = golden_cases()


def _check(name, img):
    golden = read_png(os.path.join(HERE, f"{name}.png")).astype(np.int16)
    img = to_uint8(img).astype(np.int16)
    assert img.shape == golden.shape
    diff = np.abs(img - golden)
    # Tolerate tiny fp drift (2 gray levels) on most pixels and rare
    # boundary pixels flipping at silhouettes/shadow edges.
    frac_off = (diff > 2).mean()
    assert frac_off < 0.005, f"{name}: {frac_off:.4%} pixels differ"


@pytest.mark.parametrize("bvh_width", [2, 8])
def test_teapot_matches_golden(bvh_width):
    # The 8-wide walk must land on the SAME golden as the binary one.
    _check("teapot_128x96", CASES["teapot_128x96"](bvh_width))


@pytest.mark.parametrize("name", ["sponza_160x90", "soft_spp4_128x96",
                                  "multilight_128x96", "refit_128x96"])
def test_config_family_matches_golden(name):
    _check(name, CASES[name]())
