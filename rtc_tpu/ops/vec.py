"""Vectorized 3-vector ops — the renderer's working representation.

The reference models everything as a homogeneous 4-tuple with a w flag
(reference: src/tuple.rs:6-11). Here points and vectors live as separate
(..., 3) SoA arrays; the w bookkeeping disappears because the *functions* know
whether they are transforming a point (translation applies) or a direction
(it does not). All ops broadcast over leading batch dims and are differentiable
with NaN-safe guards.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a, b):
    """Batched dot product over the last axis. (reference: src/tuple.rs:67-73)"""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Batched 3D cross product. (reference: src/tuple.rs:75-84)"""
    return jnp.cross(a, b)


def magnitude(v):
    """Euclidean norm over the last axis. (reference: src/tuple.rs:43-48)"""
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def normalize(v):
    """Unit vector; returns zeros for a zero vector (reference: src/tuple.rs:50-65).

    Uses the double-where trick so gradients stay finite at ||v|| == 0.
    """
    sq = dot(v, v)
    safe = jnp.where(sq > 0.0, sq, 1.0)
    inv = jnp.where(sq > 0.0, jnp.sqrt(safe) ** -1, 0.0)
    return v * inv[..., None]


def reflect(v, n):
    """Reflect v about unit normal n (reference: src/tuple.rs:86-91)."""
    return v - n * (2.0 * dot(v, n))[..., None]


def unpack3(v):
    """(..., 3) -> three (...,) component arrays.

    The shading stage unpacks once at its boundary and does all of its
    math on (R,) components: every op is then a plain elementwise pass over
    contiguous vectors, with no strided last axis of length 3."""
    return v[..., 0], v[..., 1], v[..., 2]


def pack3(x, y, z):
    """Three (...,) component arrays -> (..., 3) (see unpack3)."""
    return jnp.stack([x, y, z], axis=-1)


def dot3(ax, ay, az, bx, by, bz):
    """Component-form dot product (see unpack3)."""
    return ax * bx + ay * by + az * bz


def normalize3(x, y, z):
    """Component-form normalize with the same zero-vector/gradient
    semantics as normalize (see unpack3)."""
    sq = x * x + y * y + z * z
    safe = jnp.where(sq > 0.0, sq, 1.0)
    inv = jnp.where(sq > 0.0, jnp.sqrt(safe) ** -1, 0.0)
    return x * inv, y * inv, z * inv


def safe_sqrt(x):
    """sqrt clamped at zero with a FINITE gradient everywhere.

    Plain sqrt(max(x, 0)) still has an infinite derivative at x == 0, which
    turns into NaN through any chain rule with a zero factor (e.g. the
    total-internal-reflection clamp). Double-where keeps the derivative 0 for
    x <= 0."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def safe_div(num, den, eps=0.0):
    """num/den with den==0 mapped to 0 output (finite gradients)."""
    nonzero = jnp.abs(den) > eps
    den_safe = jnp.where(nonzero, den, 1.0)
    return jnp.where(nonzero, num / den_safe, 0.0)
