"""Procedural patterns (reference: src/pattern.rs).

Pattern kinds are integer codes so a heterogeneous object table can be
evaluated branchlessly per-ray: every kind's color is computed and selected by
mask (5 cheap elementwise formulas, one fused pass, no gather or switch).

The two-level texture-space pipeline (shape inverse, then pattern inverse —
reference: src/pattern.rs:98-103) is precomposed at scene-compile time into a
single (3, 4) affine per object, so sampling is one transform.
"""

from __future__ import annotations

import jax.numpy as jnp

# Deliberate, documented deviation from the reference: every floor()-based
# pattern (stripe/ring/checkers) nudges its pattern-space coordinate by
# +PATTERN_EPS before flooring. The reference samples patterns in scalar f64
# (src/pattern.rs:68-95) where axis-aligned geometry lands pattern coordinates
# EXACTLY on integer cell boundaries and the scalar evaluation order keeps the
# floor stable for free. Our wavefront path computes hit points through fused
# f32/f64 matmuls whose association order XLA may change on any refactor, so
# coordinates that land exactly on a boundary k flip between cells k-1 and k
# with ~1e-6 fusion noise (observed: ~4% of `table` pixels re-flipping per
# refactor). The nudge moves the decision boundary from k (where axis-aligned
# geometry systematically lands) to k - PATTERN_EPS (where nothing lands), so
# a coordinate within +-PATTERN_EPS of a cell boundary deterministically reads
# cell k regardless of fusion order. Cells are size 1 in pattern space, so the
# 1e-4 shift is visually nil; book conformance points sit >=0.01 from every
# boundary. Gradient is untouched (continuous lerp -> no parity to flip).
# tests/oracle.py carries the same nudge so the 1e-9 cross-check holds.
PATTERN_EPS = 1e-4

NONE = -1
STRIPE = 0
GRADIENT = 1
RING = 2
CHECKERS = 3
TEST = 4


def _parity_even(v):
    """floor-value parity matching Rust's `x % 2.0 == 0.0` on floored floats
    (reference: src/pattern.rs:71,79,86): even floor -> first color."""
    return jnp.mod(v, 2.0) == 0.0


def stripe(p, a, b):
    """(reference: src/pattern.rs:70-76; boundary-nudged, see PATTERN_EPS)"""
    cond = _parity_even(jnp.floor(p[..., 0] + PATTERN_EPS))
    return jnp.where(cond[..., None], a, b)


def gradient(p, a, b):
    """Lerp on fract(x) (reference: src/pattern.rs:77)."""
    frac = p[..., 0] - jnp.floor(p[..., 0])
    return a + (b - a) * frac[..., None]


def ring(p, a, b):
    """xz radial rings (reference: src/pattern.rs:78-84)."""
    r = jnp.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2)
    cond = _parity_even(jnp.floor(r + PATTERN_EPS))
    return jnp.where(cond[..., None], a, b)


def checkers(p, a, b):
    """3D checkerboard (reference: src/pattern.rs:85-91)."""
    s = (jnp.floor(p[..., 0] + PATTERN_EPS)
         + jnp.floor(p[..., 1] + PATTERN_EPS)
         + jnp.floor(p[..., 2] + PATTERN_EPS))
    cond = _parity_even(s)
    return jnp.where(cond[..., None], a, b)


def test(p, a, b):
    """Returns the pattern-space point as a color — the reference's
    coordinate-plumbing probe (src/pattern.rs:92-93)."""
    return p


def color_at(p, kind, a, b):
    """Branchless pattern evaluation.

    p: (..., 3) pattern-space points; kind: (...,) int codes; a/b: (..., 3).
    kind == NONE yields `a` (callers pass the material color as `a` then).
    """
    out = jnp.where((kind == NONE)[..., None], a, 0.0)
    for code, fn in ((STRIPE, stripe), (GRADIENT, gradient), (RING, ring),
                     (CHECKERS, checkers), (TEST, test)):
        out = jnp.where((kind == code)[..., None], fn(p, a, b), out)
    return out
