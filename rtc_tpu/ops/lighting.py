"""Phong shading (reference: src/material.rs:32-75).

Faithful gating:
  * diffuse + specular are zeroed in shadow (src/material.rs:57),
  * diffuse requires light_dot_normal >= 0 (src/material.rs:60 — note >=, the
    grazing case contributes a zero diffuse but still evaluates specular),
  * specular additionally requires reflect_dot_eye > 0 (src/material.rs:67),
  * specular scales the raw light intensity, NOT the effective color
    (src/material.rs:69).
"""

from __future__ import annotations

import jax.numpy as jnp

from .vec import dot3, normalize3, pack3, unpack3


def lighting(
    surface_color,     # (..., 3) pattern-resolved material color
    ambient,           # (...,)
    diffuse,           # (...,)
    specular,          # (...,)
    shininess,         # (...,)
    light_position,    # (3,) or (..., 3)
    light_intensity,   # (3,) or (..., 3)
    point,             # (..., 3)
    eyev,              # (..., 3)
    normalv,           # (..., 3)
    in_shadow,         # (...,) bool
):
    """Packed-input view of lighting3 (unpacks at the boundary)."""
    return lighting3(surface_color, ambient, diffuse, specular, shininess,
                     light_position, light_intensity, unpack3(point),
                     unpack3(eyev), unpack3(normalv), in_shadow)


def lighting3(
    surface_color,     # (..., 3) pattern-resolved material color
    ambient, diffuse, specular, shininess,     # (...,) each
    light_position,    # (3,) or (..., 3)
    light_intensity,   # (3,) or (..., 3)
    p3, e3, n3,        # component tuples: three (...,) arrays each
    in_shadow,         # (...,) bool
):
    # component (SoA) math throughout (see vec.unpack3); callers already in
    # component form (the integrator shading stage) pass tuples directly
    scx, scy, scz = unpack3(surface_color)
    lix, liy, liz = unpack3(light_intensity * jnp.ones_like(surface_color))
    px, py, pz = p3
    ex, ey, ez = e3
    nx, ny, nz = n3
    lp = light_position * jnp.ones_like(surface_color)
    lpx, lpy, lpz = unpack3(lp)

    # every multiply/add below mirrors the AoS formulation EXACTLY (same
    # association order), so f64 goldens stay bit-stable
    efx, efy, efz = scx * lix, scy * liy, scz * liz
    lvx, lvy, lvz = normalize3(lpx - px, lpy - py, lpz - pz)

    ldn = dot3(lvx, lvy, lvz, nx, ny, nz)
    lit = (~in_shadow) & (ldn >= 0.0)
    dl = diffuse * ldn
    dfx = jnp.where(lit, efx * dl, 0.0)
    dfy = jnp.where(lit, efy * dl, 0.0)
    dfz = jnp.where(lit, efz * dl, 0.0)

    # reflect(-lightv, normalv)
    k = 2.0 * dot3(-lvx, -lvy, -lvz, nx, ny, nz)
    rx, ry, rz = -lvx - nx * k, -lvy - ny * k, -lvz - nz * k
    rde = dot3(rx, ry, rz, ex, ey, ez)
    spec_on = lit & (rde > 0.0)
    # Guard pow against negative bases (gradient safety); masked out anyway.
    factor = jnp.where(spec_on, jnp.maximum(rde, 1e-30), 1.0) ** shininess
    sf = specular * factor
    spx = jnp.where(spec_on, lix * sf, 0.0)
    spy = jnp.where(spec_on, liy * sf, 0.0)
    spz = jnp.where(spec_on, liz * sf, 0.0)

    return pack3(efx * ambient + dfx + spx,
                 efy * ambient + dfy + spy,
                 efz * ambient + dfz + spz)
