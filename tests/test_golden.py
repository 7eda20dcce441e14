"""Golden-image regression tests.

The Rust reference can't be executed here (no Rust toolchain in the image),
so these goldens are OUR f64 renders, frozen after the conformance suite
(231 book tests) validated the semantics. They pin end-to-end behavior across
refactors: any change to intersection, shading, patterns, shadows,
reflection/refraction, or mesh handling shows up as a pixel diff.

Regen log: round 5 (PATTERN_EPS boundary nudge) — goldens regenerated after
making pattern sampling boundary-robust (rtc_tpu/ops/patterns.py): pattern
coords on the table scene's axis-aligned cubes land exactly on floor() cell
boundaries, and before the nudge any XLA fusion change re-flipped ~4% of
patterned pixels (the goldens churned twice in round 4 and shipped stale).
With the nudge the knife edge sits at k - 1e-4 where no geometry lands:
measured f64 renders are bit-identical across ray tilings (512/160/1024)
and the f32 render quantizes identically to the f64 golden (match_frac
1.00, was 0.80). Semantics stay pinned independently by tests/test_oracle.py
(1e-9 vs a from-scratch NumPy transliteration of the reference, carrying
the same documented nudge) and the book-conformance suite.
"""

import os

import numpy as np
import pytest

from rtc_tpu.models.scenes import REGISTRY
from rtc_tpu.render.renderer import render
from rtc_tpu.scene.compile import compile_scene
from rtc_tpu.utils.config import RenderConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _spec(v):
    """SPECS value: width or (width, max_depth)."""
    return v if isinstance(v, tuple) else (v, 5)

SPECS = {
    "default_world": 24,
    "three_spheres": 32,
    "glass_spheres": 32,
    "table": 32,
    "hexagon": 32,
    "teapot": 24,
    "teapot_smooth": 24,
    "glass_teapot": (24, 8),  # depth 8: refraction chain reaches the floor
    # flagship bench/driver scenes: every scene the benchmarks run is pinned
    "cow": 32,
    "pumpkin": 24,
    "teddy": 24,
    "single_sphere": 24,
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_golden(name):
    path = os.path.join(GOLDEN, f"{name}.npy")
    golden = np.load(path)
    width, depth = _spec(SPECS[name])
    world, cam = REGISTRY[name](width)
    scene = compile_scene(world, dtype=np.float64)
    img = np.asarray(render(
        scene, cam, RenderConfig(dtype="float64", ray_tile=512, max_depth=depth)))
    np.testing.assert_allclose(img, golden, atol=1e-9, rtol=0)


# full default-width anchors for EVERY registry scene (minus the 523k-tri
# herd): the reference's default render is 400x200 (src/main.rs:77); the
# tiny goldens above mathematically can't see sub-pixel-scale regressions
# (silhouettes, checker parity, refraction chains) — these can. f64
# end-to-end, marked slow (CPU renders ~minutes total).
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SPECS))
def test_golden_default_width(name):
    golden = np.load(os.path.join(GOLDEN, f"{name}_w400.npy"))
    _, depth = _spec(SPECS[name])  # glass_teapot keeps depth 8
    world, cam = REGISTRY[name](400)
    scene = compile_scene(world, dtype=np.float64)
    img = np.asarray(render(
        scene, cam,
        RenderConfig(dtype="float64", ray_tile=512, max_depth=depth)))
    np.testing.assert_allclose(img, golden, atol=1e-9, rtol=0)


# --- f32 production path vs f64 conformance path, all registry scenes --------
#
# The bench runs f32; conformance runs f64. This pins the f32 path to the f64
# goldens after 8-bit PPM quantization (the reference writes 0-255 PPM,
# src/canvas.rs:61-63). No epsilon retuning was needed: diffs are confined to
# genuine decision boundaries, asserted two ways per scene:
#
#   * match_frac — fraction of pixels whose 8-bit PPM bytes are IDENTICAL.
#     The shortfall is sub-pixel decision noise at these tiny golden widths.
#     (The table scene's 0.05-scale wall checkers were the worst offender at
#     0.80 until patterns.PATTERN_EPS made cell lookups boundary-robust —
#     now 1.00 with max abs err 6e-7.)
#   * flip_budget — pixels where |f32 - f64| > 0.15, i.e. structural
#     hit-vs-miss or shadow flips. Only hexagon has any: its 0.625-world-unit
#     cylinders subtend ~1 px at width 32, so silhouette pixels flip whole
#     hit decisions (measured 11-12 px). Everywhere else the budget is ~0.

F32_SPECS = dict(SPECS)

# (min exact-match fraction, structural-flip pixel budget)
F32_BUDGET = {
    "default_world": (1.0, 0),
    "three_spheres": (0.99, 1),
    "glass_spheres": (0.98, 2),
    "table": (0.99, 0),      # boundary-nudged patterns: measured 1.00
    "hexagon": (0.95, 16),   # sub-pixel silhouettes: whole hit/miss flips
    "teapot": (0.99, 2),
    "teapot_smooth": (0.99, 2),
    "glass_teapot": (0.99, 0),
    "cow": (0.98, 2),
    "pumpkin": (0.98, 2),
    "teddy": (0.98, 2),
    "single_sphere": (1.0, 0),
}


# The same two budgets at the reference's default 400x200 (used by
# chip_smoke.py phase (d) for the f32 render on the GPU). Measured f32 vs
# f64 at this width, on the CPU and on an H100: every scene matches >= 0.9997
# of pixels exactly except hexagon, whose thin cylinders flip 1033 (CPU) /
# 1081 (H100) silhouette pixels of 80,000 — the width-32 rationale above at
# 12.5x the resolution. Budgets sit just outside both measurements. They
# catch TF32: with the render path's Precision.HIGHEST removed and
# jax.default_matmul_precision("tensorfloat32"), every scene on an H100
# broke its budget (exact match 0.45-0.997, 8 to 28,395 flips).
F32_BUDGET_W400 = {
    "default_world": (0.9999, 0),
    "three_spheres": (0.999, 1),
    "glass_spheres": (0.999, 4),
    "table": (0.999, 2),
    "hexagon": (0.98, 1200),
    "teapot": (0.999, 2),
    "teapot_smooth": (0.999, 2),
    "glass_teapot": (0.999, 4),
    "cow": (0.999, 2),
    "pumpkin": (0.999, 4),
    "teddy": (0.999, 4),
    "single_sphere": (0.9999, 0),
}


def _quantize(img):
    return np.clip(np.asarray(img, np.float64) * 255.0 + 0.5, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(F32_SPECS))
def test_f32_matches_f64_after_quantization(name):
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    width, depth = _spec(F32_SPECS[name])
    world, cam = REGISTRY[name](width)
    scene = compile_scene(world, dtype=np.float32)
    img32 = np.asarray(render(
        scene, cam, RenderConfig(dtype="float32", ray_tile=512, max_depth=depth)))
    q_equal = np.all(_quantize(golden) == _quantize(img32), axis=2)
    match_frac = float(q_equal.mean())
    flips = int((np.abs(golden - img32).max(axis=2) > 0.15).sum())
    min_frac, flip_budget = F32_BUDGET[name]
    assert match_frac >= min_frac and flips <= flip_budget, (
        f"{name}: match_frac={match_frac:.4f} (min {min_frac}), "
        f"structural flips={flips} (budget {flip_budget}), max abs err "
        f"{np.max(np.abs(golden - img32)):.2e}"
    )
