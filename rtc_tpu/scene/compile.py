"""Scene compiler: builder tree -> SoA device slabs.

This is where the reference's per-ray work is hoisted to scene-build time:

  * group transforms are already pushed into leaves by the builder
    (reference: src/shape.rs:207-218 does the same push-down);
  * every inverse and inverse-transpose is precomputed ONCE in float64 on the
    host (the reference recomputes the inverse per intersection call —
    src/shape.rs:249-253 — despite its cached field);
  * triangle vertices are baked into world space, so mesh intersection needs
    no per-ray transform at all (valid because t is invariant under the
    object-to-world map when the direction is not renormalized —
    src/ray.rs:19-24);
  * the two-level pattern transform chain (src/pattern.rs:98-103) is
    precomposed into a single affine per object.

The result is a pytree of arrays (`Scene`) plus hashable static metadata
(`SceneStatic`) so the whole scene can be a jit argument.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import patterns as pattern_ops
from .shapes import KIND_CODES, Shape, triangle_edges
from .world import World

# Infinite cylinder/cone extents are clamped to +-Y_INF so f32 arithmetic on
# the params stays finite. No scene approaches this scale.
Y_INF = 1e9


class SceneStatic(NamedTuple):
    """Hashable compile-time facts used to prune the traced graph."""

    n_prims: int
    n_tris: int
    n_objects: int
    refr_prim_ids: Tuple[int, ...]  # analytic prims with ior != 1 or transparency > 0
    any_reflective: bool
    any_refractive: bool
    any_pattern: bool
    n_clusters: int = 0       # triangle clusters for the traversal kernel
    cluster_size: int = 0     # triangles per cluster (tris padded to C*L)
    any_smooth: bool = False  # any mesh carries per-corner (smooth) normals
    # mesh/triangle objects that act as refractive containers (ior != 1 or
    # transparency > 0); their triangle slabs live in Scene.refr_tri_* for
    # the n1/n2 parity walk
    refr_mesh_obj_ids: Tuple[int, ...] = ()
    # object id shared by EVERY triangle (-1 when there are several triangle
    # objects): lets the integrator replace the per-ray tri_obj gather with
    # a constant for single-mesh scenes
    single_tri_obj: int = -1


@dataclasses.dataclass
class Scene:
    """SoA scene. N analytic prims, T triangles, O objects (N + mesh leaves)."""

    # analytic primitives
    prim_kind: jnp.ndarray   # (N,) i32: 0 sphere 1 plane 2 cube 3 cylinder 4 cone
    prim_inv: jnp.ndarray    # (N, 3, 4) world->object affine
    prim_invT: jnp.ndarray   # (N, 3, 3) inverse-transpose linear part
    prim_params: jnp.ndarray  # (N, 3): ymin, ymax, capped
    prim_obj: jnp.ndarray    # (N,) i32 object ids

    # triangles (baked to world space)
    tri_p1: jnp.ndarray      # (T, 3)
    tri_e1: jnp.ndarray      # (T, 3)
    tri_e2: jnp.ndarray      # (T, 3)
    tri_n: jnp.ndarray       # (T, 3) unit world normals (flat/face)
    tri_obj: jnp.ndarray     # (T,) i32 object ids
    # per-triangle container slot for the n1/n2 census: index into
    # static.refr_mesh_obj_ids, -1 = not a container triangle. Static per
    # scene, precomputed here so the crossing-count kernel wrapper never
    # rebuilds it per bounce node (it used to cost O(K*T) jnp.where work
    # per transparent sweep).
    tri_cid: jnp.ndarray     # (T,) i32
    # per-corner smooth normals ((0,3) when the scene has none); rows of
    # flat-shaded meshes carry the face normal so interpolation is a no-op
    tri_sn1: jnp.ndarray     # (T, 3)
    tri_sn2: jnp.ndarray     # (T, 3)
    tri_sn3: jnp.ndarray     # (T, 3)

    # per-object material table (reference: src/material.rs:3-29)
    mat_color: jnp.ndarray        # (O, 3)
    mat_ambient: jnp.ndarray      # (O,)
    mat_diffuse: jnp.ndarray      # (O,)
    mat_specular: jnp.ndarray     # (O,)
    mat_shininess: jnp.ndarray    # (O,)
    mat_reflective: jnp.ndarray   # (O,)
    mat_transparency: jnp.ndarray  # (O,)
    mat_ior: jnp.ndarray          # (O,)

    # per-object pattern table; kind NONE rows carry the material color in
    # pat_a so pattern evaluation doubles as the pattern-or-color select
    # (reference: src/material.rs:42-46)
    pat_kind: jnp.ndarray    # (O,) i32
    pat_a: jnp.ndarray       # (O, 3)
    pat_b: jnp.ndarray       # (O, 3)
    pat_inv: jnp.ndarray     # (O, 3, 4) pattern_inv @ object_inv

    # triangle-cluster acceleration (k-d ordered chunks of cluster_size
    # rows; the replacement for the reference's per-group AABB cull,
    # src/shape.rs:399-425)
    cluster_aabb: jnp.ndarray     # (C, 6): min xyz, max xyz

    # refractive-mesh container slabs ((0,0,3)/(0,0) when the scene has no
    # transparent meshes): a compact copy of each refractive mesh object's
    # triangles so the n1/n2 crossing-parity walk can count per-object
    # crossings — the shape-agnostic equivalent of the reference's containers
    # walk (src/intersection.rs:29-62). refr_tri_gid carries the global
    # triangle-table row of each entry (-1 padding) so the integrator can
    # exclude the hit triangle itself from its own parity count.
    refr_tri_p1: jnp.ndarray      # (Km, Tm, 3)
    refr_tri_e1: jnp.ndarray      # (Km, Tm, 3)
    refr_tri_e2: jnp.ndarray      # (Km, Tm, 3)
    refr_tri_gid: jnp.ndarray     # (Km, Tm) i32

    # the single point light (reference: src/light.rs:5-8)
    light_pos: jnp.ndarray        # (3,)
    light_intensity: jnp.ndarray  # (3,)

    static: SceneStatic = dataclasses.field(
        default=None, metadata=dict(static=True))


jax.tree_util.register_dataclass(
    Scene,
    data_fields=[f.name for f in dataclasses.fields(Scene) if f.name != "static"],
    meta_fields=["static"],
)


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = v.astype(np.uint64) & 0x3FF
    v = (v | (v << 16)) & np.uint64(0x030000FF)
    v = (v | (v << 8)) & np.uint64(0x0300F00F)
    v = (v | (v << 4)) & np.uint64(0x030C30C3)
    v = (v | (v << 2)) & np.uint64(0x09249249)
    return v


def _kd_order(centroid: np.ndarray, leaf: int) -> np.ndarray:
    """Balanced k-d ordering: recursively split the triangle set at a
    leaf-aligned median of the widest centroid axis, so consecutive
    `leaf`-sized chunks are compact spatial cells. Compared to Morton-order
    chunking this roughly halves cluster-AABB overlap (fewer clusters
    visited per ray tile in the kernel's front-to-back traversal)."""
    out = []

    def rec(idx):
        n = len(idx)
        if n <= leaf:
            out.append(idx)
            return
        c = centroid[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        n_leaves = -(-n // leaf)
        mid = (n_leaves // 2) * leaf
        part = np.argpartition(c[:, ax], mid)
        rec(idx[part[:mid]])
        rec(idx[part[mid:]])

    rec(np.arange(len(centroid)))
    return np.concatenate(out)


def _cluster_triangles(p1, e1, e2, n, obj, sn, leaf: int):
    """Spatially order the triangles (balanced k-d median split) and chunk
    into fixed-size clusters with AABBs — the flat, gather-free acceleration
    structure the traversal kernel culls against (replacing the reference's
    per-ray group-AABB rebuild, src/shape.rs:399-425 + bounds.rs)."""
    t = len(p1)
    centroid = p1 + (e1 + e2) / 3.0
    order = _kd_order(centroid, leaf)
    p1, e1, e2, n, obj = p1[order], e1[order], e2[order], n[order], obj[order]
    if sn is not None:
        sn = sn[:, order]

    pad = (-t) % leaf
    if pad:
        z3 = np.zeros((pad, 3))
        p1 = np.concatenate([p1, z3])
        e1 = np.concatenate([e1, z3])  # zero edges -> Möller-Trumbore det guard rejects
        e2 = np.concatenate([e2, z3])
        n = np.concatenate([n, z3])
        obj = np.concatenate([obj, np.zeros((pad,), dtype=obj.dtype)])
        if sn is not None:
            sn = np.concatenate([sn, np.zeros((3, pad, 3))], axis=1)
    n_clusters = len(p1) // leaf

    aabb = np.zeros((n_clusters, 6))
    for c in range(n_clusters):
        s = slice(c * leaf, min((c + 1) * leaf, t))
        verts = np.concatenate([p1[s], p1[s] + e1[s], p1[s] + e2[s]])
        aabb[c, :3] = verts.min(axis=0)
        aabb[c, 3:] = verts.max(axis=0)
    return p1, e1, e2, n, obj, sn, aabb


def _flatten(world: World):
    leaves = []

    def walk(s: Shape):
        if s.kind == "group":
            for c in s.children:
                walk(c)
        else:
            leaves.append(s)

    for obj in world.objects:
        walk(obj)
    return leaves


def compile_scene(world: World, dtype=jnp.float32, cluster_size: int = 128,
                  containers: str = "refractive") -> Scene:
    """containers selects the n1/n2 census membership rule:

      * "refractive" (default): only objects with ior != 1 or transparency
        > 0 join the containers census. Values match the reference except in
        the degenerate shading-while-inside-an-opaque-ior-1-object case
        (such objects contribute n = 1.0 either way almost everywhere).
      * "all": EVERY object is a container, bit-matching the reference's
        walk over the full intersection list
        (/root/reference/src/intersection.rs:29-62) — a ray inside a glass
        sphere that then enters an opaque ior == 1 object sees n1 = 1.0
        (the opaque object is the latest container), not 1.5.
    """
    if containers not in ("refractive", "all"):
        raise ValueError(f"containers must be 'refractive' or 'all', "
                         f"got {containers!r}")
    dtype = jnp.dtype(dtype)
    leaves = _flatten(world)
    prims = [s for s in leaves if s.kind in KIND_CODES]
    tri_leaves = [s for s in leaves if s.kind in ("triangle", "mesh")]
    objects = prims + tri_leaves  # object-id space

    n_prims = len(prims)
    n_objects = len(objects)

    # --- analytic prims -----------------------------------------------------
    prim_kind = np.array([KIND_CODES[s.kind] for s in prims], dtype=np.int32)
    prim_obj = np.arange(n_prims, dtype=np.int32)
    prim_inv = np.zeros((n_prims, 3, 4))
    prim_invT = np.zeros((n_prims, 3, 3))
    prim_params = np.zeros((n_prims, 3))
    inv_cache = {}

    def inv_of(s: Shape) -> np.ndarray:
        key = id(s)
        if key not in inv_cache:
            inv_cache[key] = np.linalg.inv(s.transform)
        return inv_cache[key]

    for i, s in enumerate(prims):
        inv = inv_of(s)
        prim_inv[i] = inv[:3, :4]
        prim_invT[i] = inv[:3, :3].T
        prim_params[i] = [
            np.clip(s.minimum, -Y_INF, Y_INF),
            np.clip(s.maximum, -Y_INF, Y_INF),
            1.0 if s.capped else 0.0,
        ]

    # --- triangles ----------------------------------------------------------
    tp1, te1, te2, tn, tobj, tsn = [], [], [], [], [], []
    any_smooth = any(
        l.kind == "mesh" and l.vn1 is not None for l in tri_leaves)
    for li, s in enumerate(tri_leaves):
        obj_id = n_prims + li
        if s.kind == "triangle":
            v1 = s.p1[None, :]
            v2 = s.p2[None, :]
            v3 = s.p3[None, :]
        else:  # mesh
            v1, v2, v3 = s.v1, s.v2, s.v3
        # object-space edge/normal exactly as the reference triangle ctor
        # (src/shape.rs:171-193), then transform:
        _, _, n_obj = triangle_edges(v1, v2, v3)
        m = s.transform
        inv = inv_of(s)
        w1 = v1 @ m[:3, :3].T + m[:3, 3]
        w2 = v2 @ m[:3, :3].T + m[:3, 3]
        w3 = v3 @ m[:3, :3].T + m[:3, 3]
        # world normal = normalize(invT @ n_obj) (src/shape.rs:623-635)
        nw = n_obj @ inv[:3, :3]  # (n @ invT.T) == n @ inv
        norm = np.linalg.norm(nw, axis=-1, keepdims=True)
        nw = np.divide(nw, norm, out=np.zeros_like(nw), where=norm != 0)
        tp1.append(w1)
        te1.append(w2 - w1)
        te2.append(w3 - w1)
        tn.append(nw)
        tobj.append(np.full((len(w1),), obj_id, dtype=np.int32))
        if any_smooth:
            if s.kind == "mesh" and s.vn1 is not None:
                corners = []
                for vn in (s.vn1, s.vn2, s.vn3):
                    cw = vn @ inv[:3, :3]  # invT applied (row-vector form)
                    nrm = np.linalg.norm(cw, axis=-1, keepdims=True)
                    corners.append(
                        np.divide(cw, nrm, out=np.zeros_like(cw), where=nrm != 0))
                tsn.append(np.stack(corners))          # (3, T_leaf, 3)
            else:
                tsn.append(np.stack([nw, nw, nw]))      # flat: interp is a no-op

    if tp1:
        tri_p1 = np.concatenate(tp1)
        tri_e1 = np.concatenate(te1)
        tri_e2 = np.concatenate(te2)
        tri_n = np.concatenate(tn)
        tri_obj = np.concatenate(tobj)
    else:
        tri_p1 = tri_e1 = tri_e2 = tri_n = np.zeros((0, 3))
        tri_obj = np.zeros((0,), dtype=np.int32)

    tri_sn = np.concatenate(tsn, axis=1) if tsn else None

    n_clusters = 0
    if len(tri_p1) and cluster_size:
        (tri_p1, tri_e1, tri_e2, tri_n, tri_obj, tri_sn,
         cluster_aabb) = _cluster_triangles(
            tri_p1, tri_e1, tri_e2, tri_n, tri_obj, tri_sn, cluster_size)
        n_clusters = len(cluster_aabb)
    else:
        cluster_aabb = np.zeros((0, 6))
    n_tris = len(tri_p1)
    if tri_sn is None:
        tri_sn = np.zeros((3, 0, 3))

    # --- per-object material/pattern tables ---------------------------------
    def col(getter, default=0.0):
        return np.array([getter(o.material) for o in objects]) if objects else np.zeros((0,))

    mat_color = (
        np.array([o.material.color for o in objects]) if objects else np.zeros((0, 3))
    )
    mat_ambient = col(lambda m: m.ambient)
    mat_diffuse = col(lambda m: m.diffuse)
    mat_specular = col(lambda m: m.specular)
    mat_shininess = col(lambda m: m.shininess)
    mat_reflective = col(lambda m: m.reflective)
    mat_transparency = col(lambda m: m.transparency)
    mat_ior = col(lambda m: m.refractive_index)

    pat_kind = np.full((n_objects,), pattern_ops.NONE, dtype=np.int32)
    pat_a = mat_color.copy() if n_objects else np.zeros((0, 3))
    pat_b = np.zeros((n_objects, 3))
    pat_inv = np.zeros((n_objects, 3, 4))
    for i, o in enumerate(objects):
        obj_inv = inv_of(o)
        p = o.material.pattern
        if p is None:
            pat_inv[i] = obj_inv[:3, :4]
        else:
            pat_kind[i] = p.kind
            pat_a[i] = p.a
            pat_b[i] = p.b
            pat_inv[i] = (np.linalg.inv(p.transform) @ obj_inv)[:3, :4]

    def _is_container(m) -> bool:
        return (containers == "all" or m.transparency > 0.0
                or m.refractive_index != 1.0)

    refr_ids = tuple(
        int(i) for i, s in enumerate(prims) if _is_container(s.material))

    # refractive mesh containers: compact per-object triangle slabs (rows are
    # gathered AFTER Morton clustering so refr_tri_gid indexes the final
    # triangle table)
    refr_mesh_ids = tuple(
        int(n_prims + li)
        for li, s in enumerate(tri_leaves)
        if _is_container(s.material)
    )
    if refr_mesh_ids and n_tris:
        # padding rows have zero edges; a real triangle always has a nonzero
        # edge (degenerate ones would be det-guard rejected anyway)
        real = (np.abs(tri_e1).sum(axis=1) > 0) | (np.abs(tri_e2).sum(axis=1) > 0)
        rows = [np.where((tri_obj == oid) & real)[0] for oid in refr_mesh_ids]
        t_max = max((len(r) for r in rows), default=0)
        t_max = max(-(-t_max // 8) * 8, 8)
        km = len(rows)
        refr_tri_p1 = np.zeros((km, t_max, 3))
        refr_tri_e1 = np.zeros((km, t_max, 3))
        refr_tri_e2 = np.zeros((km, t_max, 3))
        refr_tri_gid = np.full((km, t_max), -1, dtype=np.int32)
        for ki, r in enumerate(rows):
            refr_tri_p1[ki, : len(r)] = tri_p1[r]
            refr_tri_e1[ki, : len(r)] = tri_e1[r]
            refr_tri_e2[ki, : len(r)] = tri_e2[r]
            refr_tri_gid[ki, : len(r)] = r
    else:
        refr_mesh_ids = ()
        refr_tri_p1 = refr_tri_e1 = refr_tri_e2 = np.zeros((0, 0, 3))
        refr_tri_gid = np.zeros((0, 0), dtype=np.int32)

    # per-triangle container slot (static per scene): -1 for non-container
    # and for padding rows (degenerate triangles would never be counted, but
    # keeping them -1 also keeps all-padding clusters out of the census
    # kernel's traversal schedule)
    tri_cid = np.full((n_tris,), -1, dtype=np.int32)
    if refr_mesh_ids:
        real_tri = (np.abs(tri_e1).sum(axis=1) > 0) | (np.abs(tri_e2).sum(axis=1) > 0)
        for k, oid in enumerate(refr_mesh_ids):
            tri_cid[(tri_obj == oid) & real_tri] = k

    static = SceneStatic(
        n_prims=n_prims,
        n_tris=n_tris,
        n_objects=n_objects,
        refr_prim_ids=refr_ids,
        refr_mesh_obj_ids=refr_mesh_ids,
        any_reflective=any(o.material.reflective > 0.0 for o in objects),
        any_refractive=any(o.material.transparency > 0.0 for o in objects),
        any_pattern=any(o.material.pattern is not None for o in objects),
        n_clusters=n_clusters,
        cluster_size=cluster_size if n_clusters else 0,
        any_smooth=bool(any_smooth and n_tris),
        single_tri_obj=(n_prims if len(tri_leaves) == 1 else -1),
    )

    f = lambda a: jnp.asarray(a, dtype=dtype)
    i32 = lambda a: jnp.asarray(a, dtype=jnp.int32)
    return Scene(
        prim_kind=i32(prim_kind),
        prim_inv=f(prim_inv),
        prim_invT=f(prim_invT),
        prim_params=f(prim_params),
        prim_obj=i32(prim_obj),
        tri_p1=f(tri_p1),
        tri_e1=f(tri_e1),
        tri_e2=f(tri_e2),
        tri_n=f(tri_n),
        tri_obj=i32(tri_obj),
        tri_cid=i32(tri_cid),
        tri_sn1=f(tri_sn[0]),
        tri_sn2=f(tri_sn[1]),
        tri_sn3=f(tri_sn[2]),
        cluster_aabb=f(cluster_aabb),
        mat_color=f(mat_color),
        mat_ambient=f(mat_ambient),
        mat_diffuse=f(mat_diffuse),
        mat_specular=f(mat_specular),
        mat_shininess=f(mat_shininess),
        mat_reflective=f(mat_reflective),
        mat_transparency=f(mat_transparency),
        mat_ior=f(mat_ior),
        pat_kind=i32(pat_kind),
        pat_a=f(pat_a),
        pat_b=f(pat_b),
        pat_inv=f(pat_inv),
        refr_tri_p1=f(refr_tri_p1),
        refr_tri_e1=f(refr_tri_e1),
        refr_tri_e2=f(refr_tri_e2),
        refr_tri_gid=i32(refr_tri_gid),
        light_pos=f(np.asarray(world.light.position, dtype=np.float64)),
        light_intensity=f(np.asarray(world.light.intensity, dtype=np.float64)),
        static=static,
    )
