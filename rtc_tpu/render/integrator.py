"""Wavefront Whitted integrator.

The reference recurses per pixel (src/world.rs:80-163); here one traced graph
processes a whole wavefront of rays per node of the (statically unrolled)
bounce tree. With the reference's budget semantics —

    internal_color_at(rem): rem < 1 -> BLACK             (src/world.rs:85-87)
      shade_hit(rem-1):                                  (src/world.rs:95)
        reflected/refracted_color(rem-2): rem-2 < 1 -> BLACK  (src/world.rs:68-69)
          internal_color_at(rem-3)                       (src/world.rs:126,159)

— each secondary ray costs 3 budget, so RECURSION_LIMIT = 5 yields exactly two
shading levels (primary + one reflect/refract pair). The unroll reproduces the
double-decrement semantics for ANY budget, including the
mutually-reflective-surfaces termination test (src/world.rs:357-373).

Everything is pure jnp: differentiable, jit/vmap/shard_map friendly. Masked
lanes carry finite dummy values so no NaNs flow through values or gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import intersect, lighting, normals, patterns
from ..ops.vec import (dot, normalize, normalize3, pack3, reflect,
                       safe_sqrt, unpack3)
from ..utils.config import RenderConfig
from ..utils.constants import BIG
from ..scene.compile import Scene

# f32 contractions stay full precision: XLA may otherwise run them as TF32
# on the GPU's tensor cores (about three decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST

# kind codes (scene.shapes.KIND_CODES)
SPHERE, PLANE, CUBE, CYLINDER, CONE = 0, 1, 2, 3, 4


class HitInfo(NamedTuple):
    t: jnp.ndarray        # (R,) hit time (BIG when miss)
    valid: jnp.ndarray    # (R,) bool
    obj: jnp.ndarray      # (R,) i32 object id (clamped valid index)
    prim: jnp.ndarray     # (R,) i32 analytic prim id (clamped)
    tri: jnp.ndarray      # (R,) i32 triangle id (clamped)
    is_tri: jnp.ndarray   # (R,) bool
    tri_n: jnp.ndarray    # (R, 3) winning triangle's world normal (pre-gathered
                          # at closest-hit time so the payload survives the
                          # cross-device min-reduction under primitive sharding)


def _local_rays(inv, o, d):
    """Transform a ray wavefront into each prim's object space.
    inv: (N, 3, 4); o/d: (R, 3) -> (R, N, 3)."""
    lin = inv[:, :, :3]
    o_l = jnp.einsum("nij,rj->rni", lin, o, precision=_HIGHEST) + inv[:, :, 3]
    d_l = jnp.einsum("nij,rj->rni", lin, d, precision=_HIGHEST)
    return o_l, d_l


def prim_candidates(scene: Scene, o, d, eps, ids=None):
    """Candidate hit slots for analytic prims: (R, N, 4) t + valid.

    Every kind's kernel runs on every prim, masked by kind — N is small, and
    straight-line masked math keeps the sweep one fused elementwise pass
    (the reference's per-kind match is at src/shape.rs:257-460).

    ids: optional static tuple restricting to a subset of prims (used by the
    refraction-index pass).
    """
    inv = scene.prim_inv
    kind = scene.prim_kind
    params = scene.prim_params
    if ids is not None:
        idx = jnp.asarray(ids, dtype=jnp.int32)
        inv, kind, params = inv[idx], kind[idx], params[idx]
    o_l, d_l = _local_rays(inv, o, d)
    ymin, ymax = params[:, 0], params[:, 1]
    capped = params[:, 2] > 0.5

    def pad4(h: intersect.Hits):
        k = h.t.shape[-1]
        if k == 4:
            return h
        pad = [(0, 0)] * (h.t.ndim - 1) + [(0, 4 - k)]
        return intersect.Hits(
            jnp.pad(h.t, pad), jnp.pad(h.valid, pad, constant_values=False)
        )

    sp = pad4(intersect.sphere(o_l, d_l))
    pl = pad4(intersect.plane(o_l, d_l, eps))
    cu = pad4(intersect.cube(o_l, d_l, eps))
    cy = pad4(intersect.cylinder(o_l, d_l, ymin, ymax, capped, eps))
    co = pad4(intersect.cone(o_l, d_l, ymin, ymax, capped, eps))

    k = kind[None, :, None]
    t = jnp.where(k == SPHERE, sp.t, 0.0)
    v = (k == SPHERE) & sp.valid
    for code, h in ((PLANE, pl), (CUBE, cu), (CYLINDER, cy), (CONE, co)):
        t = jnp.where(k == code, h.t, t)
        v = jnp.where(k == code, h.valid, v)
    return t, v


def tri_candidates(scene: Scene, o, d, eps, with_uv: bool = False):
    """Brute-force ray x triangle sweep: (R, T) t + valid (+ barycentric
    u, v when with_uv)."""
    t, valid, u, v = intersect.triangle(
        o[:, None, :], d[:, None, :],
        scene.tri_p1[None, :, :], scene.tri_e1[None, :, :], scene.tri_e2[None, :, :],
        eps,
    )
    if with_uv:
        return t, valid, u, v
    return t, valid


MESH_IMPLS = ("auto", "bruteforce", "triton")


def _resolve_mesh_impl(scene: Scene, cfg: RenderConfig, dtype) -> str:
    """The triangle search a sweep uses.

    'auto' resolves to the dense 'bruteforce' sweep on the CPU and in
    float64 (the conformance dtype), and on the GPU to the 'triton'
    cluster-traversal kernel, which measured faster end to end there
    (PERF.md). Any other platform has no measured choice and raises.
    'triton' runs the compiled GPU kernel unless cfg.interpret asks for
    the Pallas interpreter."""
    impl = cfg.mesh_impl
    if impl not in MESH_IMPLS:
        raise ValueError(f"mesh_impl must be one of {MESH_IMPLS}, got {impl!r}")
    if impl == "auto":
        platform = jax.default_backend()
        if platform == "cpu":
            impl = "bruteforce"
        elif platform == "gpu":
            impl = "triton" if dtype == jnp.float32 else "bruteforce"
        else:
            raise ValueError(
                f"mesh_impl='auto' has no triangle search for platform "
                f"{platform!r}; choose 'bruteforce' explicitly")
    if impl == "triton" and not scene.static.n_clusters:
        impl = "bruteforce"
    return impl


def mesh_search(scene: Scene, o, d, cfg: RenderConfig):
    """The closest triangle hit's row per ray: (hit (R,) bool, idx (R,) i32,
    0 on a miss). Not differentiable (an index); see mesh_closest."""
    impl = _resolve_mesh_impl(scene, cfg, o.dtype)
    if impl == "triton":
        from ..ops.pallas.mesh_intersect import closest_hit as kernel

        sg = jax.lax.stop_gradient
        _, idx = kernel(sg(o), sg(d), sg(scene.tri_p1), sg(scene.tri_e1),
                        sg(scene.tri_e2), sg(scene.cluster_aabb),
                        leaf=scene.static.cluster_size, eps=cfg.epsilon,
                        interpret=cfg.interpret)
        hit = idx >= 0
        return hit, jnp.where(hit, idx, 0)
    t, v = tri_candidates(scene, jax.lax.stop_gradient(o),
                          jax.lax.stop_gradient(d), cfg.epsilon)
    ok = v & (t >= 0.0)
    # argmin breaks ties to the lowest row, as the kernel's ascending walk
    idx = jnp.argmin(jnp.where(ok, t, BIG), axis=1).astype(jnp.int32)
    return jnp.any(ok, axis=1), idx


def mesh_closest(scene: Scene, o, d, cfg: RenderConfig, with_uv: bool = False):
    """Closest triangle hit: (t, idx) — t == BIG and idx == 0 on a miss —
    plus the winner's barycentric (u, v) when with_uv.

    One search (mesh_search: the Triton kernel or the dense jnp sweep)
    picks the winner; t and (u, v) are then recomputed by ONE gathered
    Möller-Trumbore evaluation at that triangle. The recompute is what
    autodiff sees: exact derivatives w.r.t. rays and triangle vertices
    (closed-form t, implicit-function rule), while the O(R x T) search
    stays out of the graph on every backend."""
    hit, idx = mesh_search(scene, o, d, cfg)
    t, _, u, v = intersect.triangle(
        o, d, scene.tri_p1[idx], scene.tri_e1[idx], scene.tri_e2[idx],
        cfg.epsilon)
    t = jnp.where(hit, t, BIG)
    return (t, idx, u, v) if with_uv else (t, idx)


def closest_hit(scene: Scene, o, d, cfg: RenderConfig) -> HitInfo:
    """World::intersect + Intersection::hit — global min over t >= 0
    (reference: src/world.rs:43-54, src/intersection.rs:79-84).

    Under primitive sharding (cfg.prim_axis set inside shard_map), the
    triangle table is the LOCAL shard; per-device best hits carry their
    payload (t, object id, normal) and are combined with a min-by-t
    reduction over the mesh axis — the ray-tracing analogue of
    tensor-parallel partial results + all-reduce.
    """
    R = o.shape[0]
    st = scene.static
    t_p = jnp.full((R,), BIG, o.dtype)
    idx_p = jnp.zeros((R,), jnp.int32)
    if st.n_prims:
        t, v = prim_candidates(scene, o, d, cfg.epsilon)
        tt = jnp.where(v & (t >= 0.0), t, BIG).reshape(R, -1)
        idx_flat = jnp.argmin(tt, axis=1)
        t_p = jnp.take_along_axis(tt, idx_flat[:, None], axis=1)[:, 0]
        idx_p = (idx_flat // 4).astype(jnp.int32)
    t_t = jnp.full((R,), BIG, o.dtype)
    idx_t = jnp.zeros((R,), jnp.int32)
    tri_obj = jnp.zeros((R,), jnp.int32)
    tri_n = jnp.zeros_like(o)
    if st.n_tris:
        t_t, idx_t, u, v = mesh_closest(scene, o, d, cfg, with_uv=True)
        if st.single_tri_obj >= 0:
            # single-mesh scene: every triangle shares one object id, so
            # the per-ray tri_obj gather is a constant
            tri_obj = jnp.full_like(idx_t, st.single_tri_obj)
        else:
            tri_obj = scene.tri_obj[idx_t]
        if st.any_smooth:
            # smooth-triangle shading: interpolate per-corner normals with the
            # barycentric u/v at the winner (the feature the reference stubs
            # out at src/intersection.rs:381-386); flat meshes carry the face
            # normal in all three corners, making this a no-op for them
            w0 = (1.0 - u - v)[:, None]
            tri_n = normalize(
                w0 * scene.tri_sn1[idx_t]
                + u[:, None] * scene.tri_sn2[idx_t]
                + v[:, None] * scene.tri_sn3[idx_t]
            )
        else:
            tri_n = scene.tri_n[idx_t]
        if cfg.prim_axis is not None:
            t_t, tri_obj, tri_n = _min_by_t_over_axis(
                cfg.prim_axis, t_t, tri_obj, tri_n)

    is_tri = t_t < t_p
    t_hit = jnp.where(is_tri, t_t, t_p)
    valid = t_hit < BIG * 0.5
    prim_obj = scene.prim_obj[idx_p] if st.n_prims else jnp.zeros((R,), jnp.int32)
    obj = jnp.where(is_tri, tri_obj, prim_obj)
    return HitInfo(t=t_hit, valid=valid, obj=obj, prim=idx_p, tri=idx_t,
                   is_tri=is_tri, tri_n=tri_n)


def _min_by_t_over_axis(axis_name: str, t, obj, n):
    """Combine per-device closest-hit payloads: min t wins; ties break to the
    lowest device index. Implemented as all_gather + local argmin (rather
    than pmin) so the reduction is DIFFERENTIABLE — all_gather's transpose is
    a reduce-scatter, letting hit-position gradients flow back to the shard
    that owns the winning triangle."""
    import jax

    t_all = jax.lax.all_gather(t, axis_name)          # (D, R)
    obj_all = jax.lax.all_gather(obj, axis_name)      # (D, R)
    n_all = jax.lax.all_gather(n, axis_name)          # (D, R, 3)
    win = jnp.argmin(t_all, axis=0)
    t_min = jnp.take_along_axis(t_all, win[None, :], axis=0)[0]
    obj_g = jnp.take_along_axis(obj_all, win[None, :], axis=0)[0]
    n_g = jnp.take_along_axis(n_all, win[None, :, None], axis=0)[0]
    return t_min, obj_g, n_g


class Intersections(NamedTuple):
    """Per-ray sorted intersection lists — the vectorized equivalent of the
    reference's World::intersect -> Intersections public API
    (src/world.rs:43-54, src/intersection.rs:86): fixed-capacity (R, K)
    buffers sorted ascending by t, INCLUDING negative ts (the reference's Vec
    keeps them; only hit() filters, src/intersection.rs:79-84).

    u/v carry the barycentric coordinates of triangle intersections (0.0 on
    analytic-prim slots) — the smooth-triangle payload the reference stubs
    out in its commented-out book tests (src/intersection.rs:381-386)."""

    t: jnp.ndarray      # (R, K)
    obj: jnp.ndarray    # (R, K) i32 object ids (clamped where invalid)
    valid: jnp.ndarray  # (R, K) bool
    u: jnp.ndarray = None  # (R, K) barycentric u (0 for non-triangle slots)
    v: jnp.ndarray = None  # (R, K) barycentric v (0 for non-triangle slots)


def intersect_all(scene: Scene, o, d, cfg: RenderConfig,
                  k: int | None = None) -> Intersections:
    """World::intersect for a wavefront: every object's candidate ts, merged
    and sorted ascending per ray (reference: src/world.rs:43-54).

    k bounds the returned list length (K = min(k, total candidate slots));
    k=None returns the full list. This is the conformance/utility API — the
    render path uses the fused closest_hit/is_shadowed kernels instead, which
    never materialize the list. Sweeps are brute-force (analytic candidates +
    the full triangle table), so cost is O(R * (4N + T)).
    """
    st = scene.static
    R = o.shape[0]
    parts_t, parts_v, parts_obj, parts_u, parts_w = [], [], [], [], []
    if st.n_prims:
        t, v = prim_candidates(scene, o, d, cfg.epsilon)      # (R, N, 4)
        parts_t.append(t.reshape(R, -1))
        parts_v.append(v.reshape(R, -1))
        parts_obj.append(jnp.repeat(scene.prim_obj, 4))
        parts_u.append(jnp.zeros((R, 4 * st.n_prims), t.dtype))
        parts_w.append(jnp.zeros((R, 4 * st.n_prims), t.dtype))
    if st.n_tris:
        t, v, bu, bv = tri_candidates(scene, o, d, cfg.epsilon,
                                      with_uv=True)           # (R, T)
        parts_t.append(t)
        parts_v.append(v)
        parts_obj.append(scene.tri_obj)
        parts_u.append(bu)
        parts_w.append(bv)
    if not parts_t:
        z = jnp.zeros((R, 0))
        return Intersections(t=z, obj=z.astype(jnp.int32),
                             valid=z.astype(bool), u=z, v=z)
    t = jnp.concatenate(parts_t, axis=1)
    v = jnp.concatenate(parts_v, axis=1)
    u_all = jnp.concatenate(parts_u, axis=1)
    v_all = jnp.concatenate(parts_w, axis=1)
    cols = jnp.concatenate(parts_obj)
    n_cand = t.shape[1]
    kk = n_cand if k is None else min(k, n_cand)
    tt = jnp.where(v, t, BIG)
    # K smallest ts: top_k of -t returns t ascending; ties resolve to the
    # lower candidate column, matching the reference's stable sort over the
    # object-insertion order (src/world.rs:51)
    neg, idx = jax.lax.top_k(-tt, kk)
    sel = lambda a: jnp.take_along_axis(a, idx, axis=1)
    zero_uv = lambda a: jnp.where((-neg) < BIG * 0.5, a, 0.0)
    return Intersections(
        t=-neg, obj=cols[idx], valid=(-neg) < BIG * 0.5,
        u=zero_uv(sel(u_all)), v=zero_uv(sel(v_all)))


def hit_index(xs: Intersections):
    """Intersection::hit — per-ray index (into the K axis) of the lowest
    non-negative t, or -1 when every intersection is negative/invalid
    (reference: src/intersection.rs:79-84)."""
    ok = xs.valid & (xs.t >= 0.0)
    first = jnp.argmax(ok, axis=1).astype(jnp.int32)  # lists are t-sorted
    return jnp.where(jnp.any(ok, axis=1), first, -1)


def normal_at(scene: Scene, hit: HitInfo, world_point, eps) -> jnp.ndarray:
    """World-space unit normal at the hit (reference: src/shape.rs:466-519)."""
    st = scene.static
    # triangle normals were gathered at closest-hit time (see HitInfo.tri_n)
    n_tri = hit.tri_n

    if st.n_prims:
        inv = scene.prim_inv[hit.prim]        # (R, 3, 4)
        invT = scene.prim_invT[hit.prim]      # (R, 3, 3)
        params = scene.prim_params[hit.prim]
        kind = scene.prim_kind[hit.prim]
        p_l = jnp.einsum("rij,rj->ri", inv[:, :, :3], world_point,
                         precision=_HIGHEST) + inv[:, :, 3]
        n_l = normals.sphere(p_l)
        n_l = jnp.where((kind == PLANE)[:, None], normals.plane(p_l), n_l)
        n_l = jnp.where((kind == CUBE)[:, None], normals.cube(p_l), n_l)
        n_l = jnp.where(
            (kind == CYLINDER)[:, None],
            normals.cylinder(p_l, params[:, 0], params[:, 1], eps),
            n_l,
        )
        n_l = jnp.where((kind == CONE)[:, None], normals.cone(p_l), n_l)
        n_p = normalize(
            jnp.einsum("rij,rj->ri", invT, n_l, precision=_HIGHEST))
    else:
        n_p = jnp.zeros_like(world_point)

    return jnp.where(hit.is_tri[:, None], n_tri, n_p)


def is_shadowed(scene: Scene, point, cfg: RenderConfig, live=None):
    """Shadow ray toward the light (reference: src/world.rs:100-114).

    `hit().t < distance` is equivalent to "ANY candidate t in [0, distance)",
    so the kernel path uses the cheaper any-hit occlusion kernel (no min
    bookkeeping, and a ray block stops walking once all its live rays are
    occluded).

    live: optional (R,) bool — dead lanes get max_t = -1 so the occlusion
    kernel never walks boxes for them (their shadow rays would otherwise
    point from the parking position back toward the light and drag whole
    clusters into the traversal); they report unshadowed.
    """
    v = scene.light_pos - point
    distance = jnp.sqrt(jnp.maximum(dot(v, v), 1e-30))
    direction = v / distance[:, None]
    if live is not None:
        distance = jnp.where(live, distance, -1.0)

    st = scene.static
    impl = _resolve_mesh_impl(scene, cfg, point.dtype)
    if impl == "triton":
        shadowed = jnp.zeros(point.shape[:1], bool)
        if st.n_prims:
            # dead lanes flow through this sweep too: their distance == -1
            # guarantees they report unshadowed
            t, valid = prim_candidates(scene, point, direction, cfg.epsilon)
            shadowed = jnp.any(
                valid & (t >= 0.0) & (t < distance[:, None, None]), axis=(1, 2))
        if st.n_tris:
            from ..ops.pallas.mesh_intersect import any_hit

            sg = jax.lax.stop_gradient
            found = any_hit(
                sg(point), sg(direction), sg(distance),
                sg(scene.tri_p1), sg(scene.tri_e1), sg(scene.tri_e2),
                sg(scene.cluster_aabb), leaf=st.cluster_size,
                eps=cfg.epsilon, interpret=cfg.interpret)
            if cfg.prim_axis is not None:
                # each device saw only its triangle shard: occluded anywhere
                # == OR across the 'prims' axis (one small all-reduce)
                found = jax.lax.psum(
                    found.astype(jnp.int32), cfg.prim_axis) > 0
            shadowed = shadowed | found
        return shadowed

    hit = closest_hit(scene, point, direction, cfg)
    return hit.valid & (hit.t < distance)


def object_record(scene: Scene, obj):
    """ONE fused gather of all per-object shading data.

    The shade path needs ~13 per-object lookups (pattern kind/colors/affine,
    material color + 7 scalars); concatenating the tiny (O, F) tables before
    the gather and slicing the (R, F) result turns 13 gathers into 1. All
    slices stay differentiable w.r.t. the underlying scene fields."""
    tbl = jnp.concatenate([
        scene.pat_kind[:, None].astype(scene.pat_a.dtype),      # 0
        scene.pat_a,                                            # 1:4
        scene.pat_b,                                            # 4:7
        scene.pat_inv.reshape(scene.pat_inv.shape[0], 12),      # 7:19
        scene.mat_color,                                        # 19:22
        scene.mat_ambient[:, None],                             # 22
        scene.mat_diffuse[:, None],                             # 23
        scene.mat_specular[:, None],                            # 24
        scene.mat_shininess[:, None],                           # 25
        scene.mat_reflective[:, None],                          # 26
        scene.mat_transparency[:, None],                        # 27
        scene.mat_ior[:, None],                                 # 28
    ], axis=1)
    if scene.static.n_objects == 1:
        g = jnp.broadcast_to(tbl[0], (obj.shape[0],) + tbl.shape[1:])
    else:
        g = tbl[obj]                                            # (R, 29)
    return dict(
        pat_kind=g[:, 0].astype(jnp.int32),
        pat_a=g[:, 1:4],
        pat_b=g[:, 4:7],
        pat_inv=g[:, 7:19].reshape(-1, 3, 4),
        color=g[:, 19:22],
        ambient=g[:, 22],
        diffuse=g[:, 23],
        specular=g[:, 24],
        shininess=g[:, 25],
        reflective=g[:, 26],
        transparency=g[:, 27],
        ior=g[:, 28],
    )


def refraction_indices(scene: Scene, o, d, hit: HitInfo, cfg: RenderConfig,
                       n2_enter=None):
    """n1/n2 via crossing parity — the vectorized equivalent of the
    reference's containers-stack walk over the sorted intersection list
    (src/intersection.rs:29-62).

    For each container in the static refractive set — analytic prims AND
    closed triangle meshes — count its crossings strictly before t_hit: odd
    parity == "the ray is currently inside". The stack's `last()` is the
    inside container whose most recent crossing is latest. Mesh crossings are
    counted by one batched Möller-Trumbore sweep over the compact per-object
    container slabs (Scene.refr_tri_*), so a closed transparent mesh acts as
    an n1/n2 container exactly like a glass sphere.

    Deviation (documented in ARCHITECTURE.md): by default only objects with
    ior != 1 or transparency > 0 participate as containers. Objects with
    ior == 1.0 contribute the default 1.0 in the reference, so values agree
    except in the degenerate shading-from-inside-an-opaque-object case.
    compile_scene(containers="all") reproduces the reference's every-object
    walk exactly (src/intersection.rs:29-62) by widening the static
    container sets.
    """
    ids = scene.static.refr_prim_ids
    mesh_ids = scene.static.refr_mesh_obj_ids
    R = o.shape[0]
    one = jnp.ones((R,), o.dtype)
    if n2_enter is None:
        n2_enter = scene.mat_ior[hit.obj] if scene.static.n_objects else one
    if not ids and not mesh_ids:
        return one, n2_enter

    cnts, lasts, objs = [], [], []
    if ids:
        t, v = prim_candidates(scene, o, d, cfg.epsilon, ids=ids)  # (R, Ka, 4)
        before = v & (t < hit.t[:, None, None])
        cnts.append(jnp.sum(before, axis=2))
        lasts.append(jnp.max(jnp.where(before, t, -BIG), axis=2))
        objs.append(jnp.asarray(ids, dtype=jnp.int32))  # prim id == obj id
    if mesh_ids:
        hit_gid = jnp.where(hit.is_tri, hit.tri, -2)
        t, v, _, _ = intersect.triangle(
            o[:, None, None, :], d[:, None, None, :],
            scene.refr_tri_p1[None], scene.refr_tri_e1[None],
            scene.refr_tri_e2[None], cfg.epsilon)       # (R, Km, Tm)
        # exclude the hit triangle from its own parity count: this sweep
        # recomputes t, which can land an ulp on either side of t_hit and
        # flip the parity of the crossing being shaded
        not_self = scene.refr_tri_gid[None] != hit_gid[:, None, None]
        before = v & not_self & (t < hit.t[:, None, None])
        cnts.append(jnp.sum(before, axis=2))
        lasts.append(jnp.max(jnp.where(before, t, -BIG), axis=2))
        objs.append(jnp.asarray(mesh_ids, dtype=jnp.int32))

    cnt = jnp.concatenate(cnts, axis=1)                 # (R, K)
    last = jnp.concatenate(lasts, axis=1)               # (R, K)
    cont_obj = jnp.concatenate(objs)                    # (K,)
    inside = (cnt % 2) == 1
    sub_ior = scene.mat_ior[cont_obj]                   # (K,)

    def stack_top(mask):
        score = jnp.where(mask, last, -BIG)
        j = jnp.argmax(score, axis=1)
        any_open = jnp.any(mask, axis=1)
        return jnp.where(any_open, sub_ior[j], 1.0)

    n1 = stack_top(inside)

    is_self = cont_obj[None, :] == hit.obj[:, None]
    self_inside = jnp.any(inside & is_self, axis=1)
    n2_exit = stack_top(inside & ~is_self)
    n2 = jnp.where(self_inside, n2_exit, n2_enter)
    return n1, n2


class Comps(NamedTuple):
    """prepare_computations equivalent (reference: src/intersection.rs:17-77).

    INVARIANT: n1/n2 are real refractive indices only when prepare_hit ran
    the census (need_refraction=True); otherwise they are silent 1.0
    dummies. The integrator guarantees nothing reads them in those cases
    (the Snell child and the Schlick blend exist only when the node can
    branch AND the hit material is transparent, src/world.rs:71-77,132-134);
    a new consumer of Comps.n1/n2 must re-establish this for itself."""

    point: jnp.ndarray
    eyev: jnp.ndarray
    normalv: jnp.ndarray   # flipped toward the eye when inside
    inside: jnp.ndarray
    over_point: jnp.ndarray
    under_point: jnp.ndarray
    reflectv: jnp.ndarray
    n1: jnp.ndarray
    n2: jnp.ndarray


class Comps3(NamedTuple):
    """Component (SoA) shading frame — same semantics and n1/n2 INVARIANT
    as Comps, but every 3-vector is a tuple of three (R,) arrays so the
    shading stage is plain elementwise math on (R,) vectors (see
    vec.unpack3)."""

    point: tuple
    eyev: tuple
    normalv: tuple         # flipped toward the eye when inside
    inside: jnp.ndarray
    over_point: tuple
    under_point: tuple
    reflectv: tuple
    n1: jnp.ndarray
    n2: jnp.ndarray


def prepare_hit3(scene: Scene, o, d, hit: HitInfo, cfg: RenderConfig,
                 n2_enter=None, need_refraction: bool = True) -> Comps3:
    """Derive the shading frame for a wavefront of hits, in component (SoA)
    form (reference: src/intersection.rs:17-77). Misses carry finite dummy
    values; callers mask on hit.valid. Every formula mirrors the packed
    AoS association order exactly, so f64 goldens stay pinned.

    need_refraction=False skips the n1/n2 census entirely (bounce-tree LEAF
    nodes: both secondary children are statically black, so neither Snell
    nor the Schlick blend ever reads n1/n2 — src/world.rs:85-87,117-119)."""
    eps = cfg.epsilon
    t_safe = jnp.where(hit.valid, hit.t, 1.0)
    ox, oy, oz = unpack3(o)
    dx, dy, dz = unpack3(d)
    px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
    ex, ey, ez = -dx, -dy, -dz
    if scene.static.n_prims:
        n_raw = normal_at(scene, hit, pack3(px, py, pz), eps)
    else:
        # pure-mesh scene: the kernel already selected/blended the world
        # normal (HitInfo.tri_n)
        n_raw = hit.tri_n
    nx, ny, nz = unpack3(n_raw)
    inside = (nx * ex + ny * ey + nz * ez) < 0.0
    nx = jnp.where(inside, -nx, nx)
    ny = jnp.where(inside, -ny, ny)
    nz = jnp.where(inside, -nz, nz)
    k = 2.0 * (dx * nx + dy * ny + dz * nz)
    rvx, rvy, rvz = dx - nx * k, dy - ny * k, dz - nz * k
    if need_refraction:
        n1, n2 = refraction_indices(scene, o, d, hit, cfg, n2_enter=n2_enter)
    else:
        n1 = n2 = jnp.ones(o.shape[:1], o.dtype)
    return Comps3(
        point=(px, py, pz),
        eyev=(ex, ey, ez),
        normalv=(nx, ny, nz),
        inside=inside,
        over_point=(px + nx * eps, py + ny * eps, pz + nz * eps),
        under_point=(px - nx * eps, py - ny * eps, pz - nz * eps),
        reflectv=(rvx, rvy, rvz),
        n1=n1,
        n2=n2,
    )


def prepare_hit(scene: Scene, o, d, hit: HitInfo, cfg: RenderConfig,
                n2_enter=None, need_refraction: bool = True) -> Comps:
    """Packed (R, 3) view of prepare_hit3 — the conformance-facing API
    (rtc_tpu.testing builds reference Computations from it)."""
    c = prepare_hit3(scene, o, d, hit, cfg, n2_enter=n2_enter,
                     need_refraction=need_refraction)
    return Comps(
        point=pack3(*c.point),
        eyev=pack3(*c.eyev),
        normalv=pack3(*c.normalv),
        inside=c.inside,
        over_point=pack3(*c.over_point),
        under_point=pack3(*c.under_point),
        reflectv=pack3(*c.reflectv),
        n1=c.n1,
        n2=c.n2,
    )


def schlick(cos_eye_normal, n1, n2):
    """Fresnel approximation (reference: src/intersection.rs:107-128)."""
    cos = cos_eye_normal
    n = n1 / n2
    sin2_t = n * n * (1.0 - cos * cos)
    tir = (n1 > n2) & (sin2_t > 1.0)
    cos_t = safe_sqrt(1.0 - jnp.minimum(sin2_t, 1.0))
    cos_used = jnp.where(n1 > n2, cos_t, cos)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_used) ** 5
    return jnp.where(tir, 1.0, reflectance)


def color_at(scene: Scene, o, d, cfg: RenderConfig, budget: int | None = None):
    """Whole-wavefront color (reference: src/world.rs:80-98). o/d: (R, 3)."""
    if budget is None:
        budget = cfg.max_depth
    if budget < 1:
        return jnp.zeros_like(o)

    st = scene.static
    eps = cfg.epsilon
    if st.n_objects == 0:
        return jnp.zeros_like(o)

    hit = closest_hit(scene, o, d, cfg)
    valid = hit.valid
    obj = hit.obj
    rec = object_record(scene, obj)  # one fused gather of all shading data
    # n1/n2 are read only by the Snell child and the Schlick blend, both of
    # which exist only when this node can branch AND the hit material is
    # transparent (src/world.rs:71-77,132-134) — so leaf nodes skip the
    # containers census statically
    comps = prepare_hit3(
        scene, o, d, hit, cfg, n2_enter=rec["ior"],
        need_refraction=budget >= 4 and st.any_refractive)
    px, py, pz = comps.point
    ex, ey, ez = comps.eyev
    nx, ny, nz = comps.normalv
    # Dead lanes (misses) still flow through shadow/secondary sweeps; parking
    # their ray origins far outside every AABB makes the cluster cull reject
    # them immediately instead of dragging them through triangle tests.
    # (Everything below is component/SoA math — see vec.unpack3 — packed
    # only at the kernel and recursion boundaries.)
    far = jnp.asarray(1e12, o.dtype)
    ovx, ovy, ovz = (jnp.where(valid, c, far) for c in comps.over_point)

    # pattern-space sampling; pattern-less objects read the material color
    # directly (keeping mat_color a live differentiable parameter).
    # Boundary-robust: patterns.PATTERN_EPS nudges cell lookups off the
    # floor() boundaries that axis-aligned geometry lands on, so this einsum
    # (and XLA's fusion of it) is free to reassociate.
    pat_kind = rec["pat_kind"]
    if st.any_pattern:
        point_pk = pack3(px, py, pz)
        pat_p = jnp.einsum("rij,rj->ri", rec["pat_inv"][:, :, :3], point_pk,
                           precision=_HIGHEST) + rec["pat_inv"][:, :, 3]
        base_color = patterns.color_at(pat_p, pat_kind, rec["pat_a"],
                                       rec["pat_b"])
        base_color = jnp.where(
            (pat_kind == patterns.NONE)[:, None], rec["color"], base_color)
    else:
        # no patterned object anywhere: the transform + lookup compile away
        base_color = rec["color"]

    if cfg.shadows:
        # occlusion only affects the image where the surface faces the light
        # (lighting zeroes diffuse+specular when light·normal < 0 regardless
        # of shadow, src/material.rs:57-67) — drop back-facing lanes from the
        # shadow sweep
        lvx, lvy, lvz = normalize3(
            scene.light_pos[0] - px, scene.light_pos[1] - py,
            scene.light_pos[2] - pz)
        facing = (lvx * nx + lvy * ny + lvz * nz) >= 0.0
        shadowed = is_shadowed(scene, pack3(ovx, ovy, ovz), cfg,
                               live=valid & facing)
    else:
        shadowed = jnp.zeros_like(valid)
    surface = lighting.lighting3(
        base_color,
        rec["ambient"],
        rec["diffuse"],
        rec["specular"],
        rec["shininess"],
        scene.light_pos,
        scene.light_intensity,
        (px, py, pz),
        (ex, ey, ez),
        (nx, ny, nz),
        shadowed,
    )

    can_branch = budget >= 4  # children shade only if (budget-3) >= 1
    reflective = rec["reflective"]
    transparency = rec["transparency"]

    # Dead/irrelevant secondary lanes are parked pointing AWAY from the
    # scene (origin far out on +1,1,1, direction continuing outward), so the
    # traversal schedule culls them: every AABB is behind the ray (tmax < 0).
    # Matches the reference's early-outs (reflective == 0 / transparency == 0
    # return BLACK without spawning a ray, src/world.rs:117-119,132-134).
    park = jnp.asarray(0.5773502692, o.dtype)

    refl = jnp.zeros_like(o)
    if can_branch and st.any_reflective:
        # (src/intersection.rs:27, world.rs:125)
        live_r = valid & (reflective > 0.0)
        rvx, rvy, rvz = comps.reflectv
        refl = color_at(
            scene,
            pack3(jnp.where(live_r, ovx, far), jnp.where(live_r, ovy, far),
                  jnp.where(live_r, ovz, far)),
            pack3(jnp.where(live_r, rvx, park), jnp.where(live_r, rvy, park),
                  jnp.where(live_r, rvz, park)),
            cfg, budget - 3,
        ) * reflective[:, None]

    refr = jnp.zeros_like(o)
    n1, n2 = comps.n1, comps.n2
    if can_branch and st.any_refractive:
        # Snell construction (reference: src/world.rs:140-162)
        n_ratio = n1 / n2
        cos_i = ex * nx + ey * ny + ez * nz
        sin2_t = n_ratio * n_ratio * (1.0 - cos_i * cos_i)
        tir = sin2_t > 1.0
        cos_t = safe_sqrt(1.0 - jnp.minimum(sin2_t, 1.0))
        a = n_ratio * cos_i - cos_t
        rdx, rdy, rdz = nx * a - ex * n_ratio, ny * a - ey * n_ratio, \
            nz * a - ez * n_ratio
        live_t = valid & (transparency > 0.0) & ~tir
        unx, uny, unz = (jnp.where(valid, c, far)
                         for c in comps.under_point)
        refr = (
            color_at(
                scene,
                pack3(jnp.where(live_t, unx, far),
                      jnp.where(live_t, uny, far),
                      jnp.where(live_t, unz, far)),
                pack3(jnp.where(live_t, rdx, park),
                      jnp.where(live_t, rdy, park),
                      jnp.where(live_t, rdz, park)),
                cfg, budget - 3,
            )
            * transparency[:, None]
            * jnp.where(tir, 0.0, 1.0)[:, None]
        )

    if st.any_reflective and st.any_refractive:
        # Schlick blend only when the material is both (src/world.rs:71-77)
        both = (reflective > 0.0) & (transparency > 0.0)
        reflectance = schlick(ex * nx + ey * ny + ez * nz, n1, n2)
        secondary = jnp.where(
            both[:, None],
            refl * reflectance[:, None] + refr * (1.0 - reflectance)[:, None],
            refl + refr,
        )
    else:
        secondary = refl + refr

    return jnp.where(valid[:, None], surface + secondary, 0.0)
