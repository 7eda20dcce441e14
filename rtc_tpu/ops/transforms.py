"""Affine transform factories (reference: src/transformations.rs).

All return (4, 4) arrays. Composition order matches the reference: C @ B @ A
applies A first (src/transformations.rs:267-275). `affine_inverse` and
`affine_inverse_transpose` are the scene compiler's analytic replacements for
the reference's cofactor inverse.

Implemented with jnp so transforms are traceable/differentiable — object poses
are legitimate optimization targets for the differentiable renderer.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

# full f32 (not TF32) for the affine contractions on the GPU
_HIGHEST = jax.lax.Precision.HIGHEST


def _traced(*vals) -> bool:
    """True if any arg is a JAX value (tracer or device array).

    Scene building happens host-side with Python floats — there the factories
    return NUMPY f64 matrices so no tiny device programs are compiled (eager
    single-op programs compile on every first call). Inside jit /
    grad, tracer inputs route to the jnp path so transforms stay
    differentiable.
    """
    return any(isinstance(v, (jax.Array, jax.core.Tracer)) for v in vals)


def translation(x, y, z):
    """(reference: src/transformations.rs:4-11)"""
    if not _traced(x, y, z):
        m = np.eye(4)
        m[0, 3], m[1, 3], m[2, 3] = x, y, z
        return m
    m = jnp.eye(4, dtype=jnp.result_type(float))
    return m.at[0, 3].set(x).at[1, 3].set(y).at[2, 3].set(z)


def scaling(x, y, z):
    """(reference: src/transformations.rs:13-21)"""
    if not _traced(x, y, z):
        return np.diag([float(x), float(y), float(z), 1.0])
    m = jnp.eye(4, dtype=jnp.result_type(float))
    return m.at[0, 0].set(x).at[1, 1].set(y).at[2, 2].set(z)


def rotation_x(rad):
    """(reference: src/transformations.rs:23-35)"""
    if not _traced(rad):
        c, s = math.cos(rad), math.sin(rad)
        m = np.eye(4)
        m[1, 1] = c; m[2, 2] = c; m[1, 2] = -s; m[2, 1] = s
        return m
    c, s = jnp.cos(rad), jnp.sin(rad)
    m = jnp.eye(4, dtype=jnp.result_type(float))
    return m.at[1, 1].set(c).at[2, 2].set(c).at[1, 2].set(-s).at[2, 1].set(s)


def rotation_y(rad):
    """(reference: src/transformations.rs:37-49)"""
    if not _traced(rad):
        c, s = math.cos(rad), math.sin(rad)
        m = np.eye(4)
        m[0, 0] = c; m[2, 2] = c; m[0, 2] = s; m[2, 0] = -s
        return m
    c, s = jnp.cos(rad), jnp.sin(rad)
    m = jnp.eye(4, dtype=jnp.result_type(float))
    return m.at[0, 0].set(c).at[2, 2].set(c).at[0, 2].set(s).at[2, 0].set(-s)


def rotation_z(rad):
    """(reference: src/transformations.rs:51-63)"""
    if not _traced(rad):
        c, s = math.cos(rad), math.sin(rad)
        m = np.eye(4)
        m[0, 0] = c; m[1, 1] = c; m[0, 1] = -s; m[1, 0] = s
        return m
    c, s = jnp.cos(rad), jnp.sin(rad)
    m = jnp.eye(4, dtype=jnp.result_type(float))
    return m.at[0, 0].set(c).at[1, 1].set(c).at[0, 1].set(-s).at[1, 0].set(s)


def shearing(xy, xz, yx, yz, zx, zy):
    """(reference: src/transformations.rs:65-78)"""
    if not _traced(xy, xz, yx, yz, zx, zy):
        m = np.eye(4)
        m[0, 1], m[0, 2] = xy, xz
        m[1, 0], m[1, 2] = yx, yz
        m[2, 0], m[2, 1] = zx, zy
        return m
    m = jnp.eye(4, dtype=jnp.result_type(float))
    return (
        m.at[0, 1].set(xy).at[0, 2].set(xz)
        .at[1, 0].set(yx).at[1, 2].set(yz)
        .at[2, 0].set(zx).at[2, 1].set(zy)
    )


def view_transform(from_pt, to_pt, up):
    """Camera world->view matrix (reference: src/transformations.rs:80-93).

    Args are (3,) arrays or sequences.
    """
    if not _traced(from_pt, to_pt, up):
        f = np.asarray(to_pt, dtype=np.float64) - np.asarray(from_pt, dtype=np.float64)
        f = f / np.linalg.norm(f)
        upn = np.asarray(up, dtype=np.float64)
        upn = upn / np.linalg.norm(upn)
        left = np.cross(f, upn)
        true_up = np.cross(left, f)
        orientation = np.eye(4)
        orientation[0, :3] = left
        orientation[1, :3] = true_up
        orientation[2, :3] = -f
        return orientation @ translation(*(-np.asarray(from_pt, dtype=np.float64)))

    from . import vec

    from_pt = jnp.asarray(from_pt, dtype=jnp.result_type(float))
    to_pt = jnp.asarray(to_pt, dtype=jnp.result_type(float))
    up = jnp.asarray(up, dtype=jnp.result_type(float))

    forward = vec.normalize(to_pt - from_pt)
    left = vec.cross(forward, vec.normalize(up))
    true_up = vec.cross(left, forward)

    orientation = jnp.stack(
        [
            jnp.concatenate([left, jnp.zeros((1,), left.dtype)]),
            jnp.concatenate([true_up, jnp.zeros((1,), left.dtype)]),
            jnp.concatenate([-forward, jnp.zeros((1,), left.dtype)]),
            jnp.array([0.0, 0.0, 0.0, 1.0], left.dtype),
        ]
    )
    return orientation @ translation(-from_pt[0], -from_pt[1], -from_pt[2])


def affine_inverse(m):
    """Analytic inverse of an affine (4, 4) transform: [R t; 0 1]^-1 = [R^-1, -R^-1 t].

    Replaces the reference's generic cofactor inverse for transforms
    (src/matrix.rs:138-157), which it recomputed per ray (src/shape.rs:249-253).
    """
    lin = m[..., :3, :3]
    trans = m[..., :3, 3]
    lin_inv = jnp.linalg.inv(lin)
    t_inv = -jnp.einsum("...ij,...j->...i", lin_inv, trans,
                        precision=_HIGHEST)
    top = jnp.concatenate([lin_inv, t_inv[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], m.dtype), m.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def transform_points(m, pts):
    """Apply a (4,4) (or (...,3,4) affine) transform to (..., 3) points."""
    lin = m[..., :3, :3]
    trans = m[..., :3, 3]
    return jnp.einsum("...ij,...j->...i", lin, pts,
                      precision=_HIGHEST) + trans


def transform_dirs(m, dirs):
    """Apply the linear part of a transform to (..., 3) directions."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], dirs,
                      precision=_HIGHEST)
