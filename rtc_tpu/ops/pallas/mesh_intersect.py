"""Ray x triangle-cluster traversal kernels, written for the GPU through
Pallas with ``backend="triton"``.

The hot op of the renderer (the reference walks a group tree per ray,
src/shape.rs:399-436). Design:

  * one program per block of ``block_rays`` rays (a power of two); each ray
    keeps its running (t_best, idx_best) in registers;
  * triangles stay in device memory as a (9, T) SoA table [p1 | e1 | e2],
    ordered into spatially compact clusters of ``leaf`` rows
    (scene/compile.py), with one AABB per cluster and one per group of
    ``SUPER_WIDTH`` clusters (built here from the cluster boxes);
  * the program loops over the groups, then over their clusters, slab-tests
    every ray of the block against each box and skips the box with
    ``lax.cond`` when no ray overlaps it or when its entry t is at or beyond
    every overlapping ray's current best hit;
  * a visited cluster runs Möller-Trumbore in plain f32 arithmetic on a
    (block_rays, CHUNK) tile, ``CHUNK`` triangles at a time, and folds the
    tile's per-ray minimum into the running best (ties go to the lowest
    triangle row, like ``jnp.argmin`` in the brute-force sweep).

The kernels return only the winner (or the occlusion flag). The integrator
recomputes t, and any shading payload, at the winning triangle in plain jnp,
so the search stays out of the autodiff graph and needs no derivative rule.

``interpret=True`` runs the same kernels in the Pallas interpreter on the
CPU; nothing chooses it unless the caller asks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ...utils.constants import BIG, EPSILON

# clusters per group in the two-level box hierarchy
SUPER_WIDTH = 8
# rays per program (one ray per lane) and triangles per Möller-Trumbore tile
BLOCK_RAYS = 128
CHUNK = 16
NUM_WARPS = 4

# Boxes are widened by this relative margin (plus the same absolute amount)
# so that f32 rounding in the slab test can never cull a box whose
# triangles a ray really hits (flat, axis-aligned clusters have zero width).
_BOX_PAD = 1e-5


def _inv_dir(d):
    near0 = jnp.abs(d) < 1e-30
    return jnp.where(near0, jnp.where(d >= 0.0, BIG, -BIG),
                     1.0 / jnp.where(near0, 1.0, d))


def _slab(box_ref, b, o, inv):
    """Entry/exit t of each ray against box b of a flat (N * 8,) table
    [lo_xyz | hi_xyz | valid | 0], plus the box's valid flag."""
    base = b * 8
    tmin = tmax = None
    for ax in range(3):
        t1 = (box_ref[base + ax] - o[ax]) * inv[ax]
        t2 = (box_ref[base + 3 + ax] - o[ax]) * inv[ax]
        lo_t, hi_t = jnp.minimum(t1, t2), jnp.maximum(t1, t2)
        tmin = lo_t if tmin is None else jnp.maximum(tmin, lo_t)
        tmax = hi_t if tmax is None else jnp.minimum(tmax, hi_t)
    return tmin, tmax, box_ref[base + 6] > 0.0


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _mt_tile(tri_ref, start, o, d, eps):
    """Möller-Trumbore (src/shape.rs:437-459) of the block's rays against
    triangle rows [start, start + CHUNK): (t, ok), each (block_rays, CHUNK);
    ok includes t >= 0."""
    rows = [tri_ref[k, pl.ds(start, CHUNK)][None, :] for k in range(9)]
    p1, e1, e2 = rows[0:3], rows[3:6], rows[6:9]
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    # pvec = d x e2; det = e1 . pvec
    px = dy * e2[2] - dz * e2[1]
    py = dz * e2[0] - dx * e2[2]
    pz = dx * e2[1] - dy * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    det_ok = jnp.abs(det) >= eps
    f = 1.0 / jnp.where(det_ok, det, 1.0)
    sx, sy, sz = ox - p1[0], oy - p1[1], oz - p1[2]
    u = f * (sx * px + sy * py + sz * pz)
    # qvec = s x e1
    qx = sy * e1[2] - sz * e1[1]
    qy = sz * e1[0] - sx * e1[2]
    qz = sx * e1[1] - sy * e1[0]
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2[0] * qx + e2[1] * qy + e2[2] * qz)
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= 0.0))
    return t, ok


def _traverse(sbox_ref, box_ref, o, inv, wanted, visit, carry, *,
              n_super: int, more=None):
    """Two-level box walk shared by both kernels. wanted(tmin, tmax, carry)
    -> (rays,) bool says which rays still need a box; visit(c, carry)
    tests cluster c; more(carry), when given, ends the walk early once it
    is False (any-hit: every live ray is occluded)."""

    def box_go(ref, b, carry):
        tmin, tmax, valid = _slab(ref, b, o, inv)
        return valid & _any(wanted(tmin, tmax, carry))

    def cluster_step(c, carry):
        return jax.lax.cond(box_go(box_ref, c, carry), lambda cr: visit(c, cr),
                            lambda cr: cr, carry)

    def group(s, carry):
        def inner(cr):
            return jax.lax.fori_loop(
                0, SUPER_WIDTH,
                lambda k, cr2: cluster_step(s * SUPER_WIDTH + k, cr2), cr)
        return jax.lax.cond(box_go(sbox_ref, s, carry), inner,
                            lambda cr: cr, carry)

    if more is None:
        return jax.lax.fori_loop(0, n_super, group, carry)

    def cond(state):
        s, cr = state
        return (s < n_super) & more(cr)

    def body(state):
        s, cr = state
        return s + 1, group(s, cr)

    return jax.lax.while_loop(cond, body, (jnp.int32(0), carry))[1]


def _closest_kernel(ray_ref, sbox_ref, box_ref, tri_ref, t_ref, idx_ref, *,
                    n_super: int, leaf: int, eps: float):
    o = tuple(ray_ref[k, :] for k in range(3))
    d = tuple(ray_ref[3 + k, :] for k in range(3))
    inv = tuple(_inv_dir(c) for c in d)
    n = o[0].shape[0]

    def wanted(tmin, tmax, carry):
        return (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < carry[0])

    def visit(c, carry):
        def tile(j, cr):
            best_t, best_i = cr
            start = c * leaf + j * CHUNK
            t, ok = _mt_tile(tri_ref, start, o, d, eps)
            tt = jnp.where(ok, t, BIG)
            t_c = jnp.min(tt, axis=1)
            i_c = jax.lax.argmin(tt, 1, jnp.int32) + start
            better = t_c < best_t
            return (jnp.where(better, t_c, best_t),
                    jnp.where(better, i_c, best_i))
        return jax.lax.fori_loop(0, leaf // CHUNK, tile, carry)

    init = (jnp.full((n,), BIG, jnp.float32), jnp.full((n,), -1, jnp.int32))
    best_t, best_i = _traverse(sbox_ref, box_ref, o, inv, wanted, visit, init,
                               n_super=n_super)
    t_ref[...] = best_t
    idx_ref[...] = best_i


def _any_kernel(ray_ref, sbox_ref, box_ref, tri_ref, hit_ref, *,
                n_super: int, leaf: int, eps: float):
    o = tuple(ray_ref[k, :] for k in range(3))
    d = tuple(ray_ref[3 + k, :] for k in range(3))
    max_t = ray_ref[6, :]
    inv = tuple(_inv_dir(c) for c in d)
    n = o[0].shape[0]
    live = max_t > 0.0

    def wanted(tmin, tmax, found):
        return ((tmax >= jnp.maximum(tmin, 0.0)) & (tmin < max_t) & live
                & (found == 0))

    def visit(c, found):
        def tile(j, fd):
            t, ok = _mt_tile(tri_ref, c * leaf + j * CHUNK, o, d, eps)
            hit = jnp.max((ok & (t < max_t[:, None])).astype(jnp.int32),
                          axis=1)
            return jnp.maximum(fd, hit)
        return jax.lax.fori_loop(0, leaf // CHUNK, tile, found)

    def more(found):
        return _any(live & (found == 0))

    found = _traverse(sbox_ref, box_ref, o, inv, wanted, visit,
                      jnp.zeros((n,), jnp.int32), n_super=n_super, more=more)
    hit_ref[...] = found


def box_tables(cluster_aabb):
    """Flat (C' * 8,) cluster and (S * 8,) group box tables for the kernels:
    [lo_xyz | hi_xyz | valid | 0] per box, padded to a multiple of
    SUPER_WIDTH clusters, boxes widened by _BOX_PAD; empty boxes (lo > hi)
    are marked invalid."""
    box = cluster_aabb.astype(jnp.float32)
    pad = (-box.shape[0]) % SUPER_WIDTH
    empty = jnp.tile(jnp.asarray([[1.0, 1.0, 1.0, -1.0, -1.0, -1.0]],
                                 jnp.float32), (pad, 1))
    box = jnp.concatenate([box, empty])
    lo, hi = box[:, :3], box[:, 3:]
    valid = jnp.all(lo <= hi, axis=1)
    margin = _BOX_PAD * (1.0 + jnp.maximum(jnp.abs(lo), jnp.abs(hi)))
    lo, hi = lo - margin, hi + margin
    g_lo = jnp.where(valid[:, None], lo, BIG).reshape(-1, SUPER_WIDTH, 3)
    g_hi = jnp.where(valid[:, None], hi, -BIG).reshape(-1, SUPER_WIDTH, 3)
    g_valid = jnp.any(valid.reshape(-1, SUPER_WIDTH), axis=1)

    def flat(lo, hi, ok):
        z = jnp.zeros_like(ok, jnp.float32)[:, None]
        return jnp.concatenate(
            [lo, hi, ok.astype(jnp.float32)[:, None], z], axis=1).reshape(-1)

    return (flat(jnp.min(g_lo, axis=1), jnp.max(g_hi, axis=1), g_valid),
            flat(lo, hi, valid))


def _ray_table(o, d, max_t, block_rays: int):
    """(8, R') SoA ray rows [o | d | max_t | 0], padded to a whole number of
    blocks with rays that overlap no box and never report a hit."""
    r = o.shape[0]
    pad = (-r) % block_rays
    o = jnp.pad(o.astype(jnp.float32), ((0, pad), (0, 0)),
                constant_values=BIG)
    d = jnp.pad(d.astype(jnp.float32), ((0, pad), (0, 0)),
                constant_values=1.0)
    m = jnp.pad(max_t.astype(jnp.float32), (0, pad), constant_values=-1.0)
    return jnp.concatenate(
        [o.T, d.T, m[None, :], jnp.zeros_like(m)[None, :]], axis=0)


def _call(kernel, rays, tri_p1, tri_e1, tri_e2, cluster_aabb, n_out, out_dtypes,
          *, leaf, eps, block_rays, interpret):
    assert leaf % CHUNK == 0 and block_rays & (block_rays - 1) == 0
    sbox, box = box_tables(cluster_aabb)
    tri = jnp.concatenate([tri_p1.T, tri_e1.T, tri_e2.T]).astype(jnp.float32)
    rp = rays.shape[1]
    kern = functools.partial(kernel, n_super=sbox.shape[0] // 8, leaf=leaf,
                             eps=eps)
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    outs = pl.pallas_call(
        kern,
        grid=(rp // block_rays,),
        in_specs=[pl.BlockSpec((8, block_rays), lambda i: (0, i)),
                  whole(sbox), whole(box), whole(tri)],
        out_specs=[pl.BlockSpec((block_rays,), lambda i: (i,))] * n_out,
        out_shape=[jax.ShapeDtypeStruct((rp,), dt) for dt in out_dtypes],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(rays, sbox, box, tri)
    return outs


@functools.partial(
    jax.jit, static_argnames=("leaf", "eps", "block_rays", "interpret"))
def closest_hit(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb, *, leaf: int,
                eps: float = EPSILON, block_rays: int = BLOCK_RAYS,
                interpret: bool = False):
    """Closest triangle hit with t >= 0 per ray: (t (R,) f32, idx (R,) i32),
    t == BIG and idx == -1 on a miss. tri_*: (T, 3) with T == C * leaf;
    cluster_aabb: (C, 6) [lo | hi] (lo > hi marks an empty cluster)."""
    r = o.shape[0]
    rays = _ray_table(o, d, jnp.zeros((r,), jnp.float32), block_rays)
    t, idx = _call(_closest_kernel, rays, tri_p1, tri_e1, tri_e2,
                   cluster_aabb, 2, (jnp.float32, jnp.int32), leaf=leaf,
                   eps=eps, block_rays=block_rays, interpret=interpret)
    return t[:r], idx[:r]


@functools.partial(
    jax.jit, static_argnames=("leaf", "eps", "block_rays", "interpret"))
def any_hit(o, d, max_t, tri_p1, tri_e1, tri_e2, cluster_aabb, *, leaf: int,
            eps: float = EPSILON, block_rays: int = BLOCK_RAYS,
            interpret: bool = False):
    """Occlusion query: True where some triangle lies at t in [0, max_t)
    along the ray. Rays with max_t <= 0 (dead lanes) report False and never
    hold a program's walk open."""
    r = o.shape[0]
    rays = _ray_table(o, d, max_t, block_rays)
    (hit,) = _call(_any_kernel, rays, tri_p1, tri_e1, tri_e2, cluster_aabb,
                   1, (jnp.int32,), leaf=leaf, eps=eps, block_rays=block_rays,
                   interpret=interpret)
    return hit[:r] != 0
