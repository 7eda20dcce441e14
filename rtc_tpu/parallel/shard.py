"""Sharded rendering over a device mesh with shard_map.

Two axes (see parallel.mesh):
  * rays sharded over 'rays' (data parallel — always);
  * the triangle table optionally sharded over 'prims' (tensor parallel for
    large scenes), with per-device partial closest-hits combined by a
    min-by-t reduction across devices (integrator._min_by_t_over_axis).

Scene materials/patterns/analytic prims are small and replicated; only the
triangle slabs shard. XLA inserts the collectives from the shard_map specs.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..render import integrator
from ..render.camera import Camera, camera_rays
from ..render.renderer import tile_rays
from ..scene.compile import Scene
from ..utils.config import DEFAULT_CONFIG, RenderConfig

_TRI_FIELDS = ("tri_p1", "tri_e1", "tri_e2", "tri_n", "tri_obj", "tri_cid",
               "tri_sn1", "tri_sn2", "tri_sn3")


def scene_pspecs(scene: Scene, shard_prims: bool) -> Scene:
    """A Scene-shaped pytree of PartitionSpecs. Under primitive sharding the
    triangle slabs AND the cluster-AABB table shard together (clusters are
    contiguous k-d ordered chunks of the triangle table, so a contiguous
    tri shard owns a contiguous cluster range — each device keeps a valid
    local acceleration structure and the traversal kernels run per shard)."""
    specs = {}
    n_c = scene.static.n_clusters
    for f in dataclasses.fields(Scene):
        if f.name == "static":
            continue
        arr = getattr(scene, f.name)
        shard = False
        if shard_prims and hasattr(arr, "shape") and arr.shape[0]:
            if f.name in _TRI_FIELDS and arr.shape[0] == scene.static.n_tris:
                shard = True
            if f.name == "cluster_aabb" and arr.shape[0] == n_c:
                shard = True
        specs[f.name] = (
            P("prims", *([None] * (arr.ndim - 1))) if shard else P())
    return Scene(**specs, static=scene.static)


def pad_tris(scene: Scene, multiple: int) -> Scene:
    """Pad the triangle table with degenerate (never-hit) triangles so it
    splits evenly across the 'prims' axis. Degenerate rows have zero edges,
    so Möller-Trumbore's det-epsilon guard rejects them.

    When the scene carries a cluster acceleration structure, padding happens
    at CLUSTER granularity (empty boxes + degenerate leaves) so each shard
    keeps T_local == C_local * leaf and the traversal kernels stay usable."""
    n = scene.static.n_tris
    leaf = scene.static.cluster_size
    if leaf and scene.static.n_clusters:
        n_c = scene.static.n_clusters
        cpad = (-n_c) % multiple
        if cpad == 0:
            return scene
        empty = jnp.zeros((cpad, 6), scene.cluster_aabb.dtype)
        empty = empty.at[:, :3].set(1.0).at[:, 3:].set(-1.0)
        repl = {"cluster_aabb": jnp.concatenate([scene.cluster_aabb, empty])}
        for name in _TRI_FIELDS:
            arr = getattr(scene, name)
            if arr.shape[0] != n:
                continue
            widths = [(0, cpad * leaf)] + [(0, 0)] * (arr.ndim - 1)
            # tri_cid pads with -1 (0 is a valid container slot)
            repl[name] = jnp.pad(arr, widths,
                                 constant_values=-1 if name == "tri_cid" else 0)
        static = scene.static._replace(
            n_tris=n + cpad * leaf, n_clusters=n_c + cpad)
        return dataclasses.replace(scene, **repl, static=static)
    if n % multiple == 0 and n > 0:
        return scene
    pad = multiple - (n % multiple) if n else multiple
    repl = {}
    for name in _TRI_FIELDS:
        arr = getattr(scene, name)
        if arr.shape[0] != n:  # e.g. empty smooth-normal slabs
            continue
        widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        repl[name] = jnp.pad(arr, widths,
                             constant_values=-1 if name == "tri_cid" else 0)
    static = scene.static._replace(n_tris=n + pad)
    return dataclasses.replace(scene, **repl, static=static)


def _tiled_color(scene: Scene, o, d, cfg: RenderConfig):
    """Per-device tiled wavefront loop (same shape as renderer._render_rays)."""
    n_rays = o.shape[0]
    tile = tile_rays(scene, cfg, n_rays)
    n_tiles = -(-n_rays // tile)
    pad = n_tiles * tile - n_rays
    o = jnp.pad(o, ((0, pad), (0, 0)))
    d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)

    def one_tile(od):
        ot, dt = od
        return integrator.color_at(scene, ot, dt, cfg)

    colors = jax.lax.map(
        one_tile, (o.reshape(n_tiles, tile, 3), d.reshape(n_tiles, tile, 3))
    )
    return colors.reshape(-1, 3)[:n_rays]


@partial(jax.jit, static_argnames=("cfg", "mesh", "shard_prims"))
def _render_sharded_rays(scene: Scene, o, d, cfg: RenderConfig, mesh: Mesh,
                         shard_prims: bool):
    inner_cfg = dataclasses.replace(
        cfg, prim_axis="prims" if shard_prims else None)

    def shard_fn(scene_l, o_l, d_l):
        return _tiled_color(scene_l, o_l, d_l, inner_cfg)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(scene_pspecs(scene, shard_prims), P("rays"), P("rays")),
        out_specs=P("rays"),
        check_vma=False,
    )(scene, o, d)


import functools

import numpy as np


@functools.lru_cache(maxsize=16)
def _balanced_morton_perm(vsize: int, hsize: int, n_shards: int, tile: int):
    """(perm, inv) composing two static reorderings:

    1. Morton order — each `tile`-ray block is a compact screen region, so
       the traversal kernel's box tests cull sharply (render/order.py);
    2. round-robin tile dealing — tile k goes to device k % D, so every
       device receives a spatially-spread MIX of screen regions. A contiguous
       Morton split would concentrate the geometry-heavy regions on one or
       two devices (data-parallel stragglers); dealing keeps per-device work
       even while preserving intra-tile coherence.

    Returns index arrays over the PADDED ray count (multiple of D * tile).
    """
    from ..render.order import morton_perm

    mperm, _ = morton_perm(vsize, hsize)
    n = vsize * hsize
    padded = -(-n // (n_shards * tile)) * (n_shards * tile)
    full = np.concatenate([mperm, np.arange(n, padded, dtype=np.int32)])
    # perm[slot] = source pixel; slot layout (D, nb/D, tile) gives device d
    # the Morton tiles d, d+D, d+2D, ...
    perm = (full.reshape(-1, n_shards, tile)
            .transpose(1, 0, 2)
            .reshape(-1))
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm.astype(np.int32), inv


def _to_global(mesh: Mesh, spec, x):
    """Lift a process-local (but globally identical) array to a global
    jax.Array laid out by (mesh, spec). Every process holds the full value,
    so the callback can serve any addressable shard — the standard
    multi-controller input recipe."""
    sh = jax.sharding.NamedSharding(mesh, spec)
    xnp = np.asarray(x)
    return jax.make_array_from_callback(xnp.shape, sh, lambda idx: xnp[idx])


def sharded_colors(scene: Scene, camera: Camera,
                   cfg: RenderConfig = DEFAULT_CONFIG,
                   mesh: Mesh | None = None, shard_prims: bool = False):
    """Shard rays over mesh axis 'rays' (and optionally triangles over
    'prims') and shade. Returns (colors, inv_perm, n_rays): colors is the
    (padded R, 3) ray-major jax.Array, still in the sharded traversal order;
    inv_perm (or None) undoes the Morton/deal permutation.

    Works single- OR multi-process: under multi-controller JAX the inputs
    are lifted to global arrays via make_array_from_callback, and the caller
    must allgather colors before indexing (see multihost.render_multihost).
    """
    from .mesh import make_mesh

    mesh = mesh or make_mesh()
    n_ray_shards = mesh.shape["rays"]
    n_prim_shards = mesh.shape.get("prims", 1)

    dtype = cfg.jnp_dtype()
    if shard_prims and n_prim_shards > 1:
        scene = pad_tris(scene, n_prim_shards)

    o, d = camera_rays(
        jnp.asarray(camera.transform_inverse, dtype),
        camera.hsize, camera.vsize,
        jnp.asarray(camera.half_width, dtype),
        jnp.asarray(camera.half_height, dtype),
        jnp.asarray(camera.pixel_size, dtype),
        dtype,
    )
    n_rays = o.shape[0]
    morton = cfg.ray_order == "morton"
    inv = None
    if morton:
        tile = tile_rays(scene, cfg, max(128, n_rays // n_ray_shards))
        perm, inv = _balanced_morton_perm(
            camera.vsize, camera.hsize, n_ray_shards, tile)
        pad = len(perm) - n_rays
        o = jnp.pad(o, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
        o, d = o[jnp.asarray(perm)], d[jnp.asarray(perm)]
        cfg = dataclasses.replace(cfg, ray_order="scanline")
    else:
        pad = (-n_rays) % n_ray_shards
        o = jnp.pad(o, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)

    shard_p = shard_prims and n_prim_shards > 1
    if jax.process_count() > 1:
        # multi-controller: every process computed identical full inputs;
        # lift them onto the global mesh so jit can dispatch SPMD
        pspecs = scene_pspecs(scene, shard_p)
        # tree_map per field: absent fields (None) globalize leaf-by-leaf
        # under the field's prefix spec
        scene = dataclasses.replace(scene, **{
            f.name: jax.tree_util.tree_map(
                lambda x, _s=getattr(pspecs, f.name): _to_global(mesh, _s, x),
                getattr(scene, f.name))
            for f in dataclasses.fields(Scene) if f.name != "static"
        })
        o = _to_global(mesh, P("rays"), o)
        d = _to_global(mesh, P("rays"), d)

    colors = _render_sharded_rays(scene, o, d, cfg, mesh, shard_p)
    return colors, inv, n_rays


def render_sharded(scene: Scene, camera: Camera, cfg: RenderConfig = DEFAULT_CONFIG,
                   mesh: Mesh | None = None, shard_prims: bool = False):
    """Render with rays sharded over mesh axis 'rays' (and optionally the
    triangle table over 'prims'). Returns an (V, H, 3) image. Single-process
    assembly; for several hosts use multihost.render_multihost.

    Ray order: Morton tiles dealt round-robin across the 'rays' axis for
    load balance (see _balanced_morton_perm); pure permutation, applied
    outside the sharded jit.
    """
    colors, inv, n_rays = sharded_colors(scene, camera, cfg, mesh, shard_prims)
    if inv is not None:
        colors = colors[jnp.asarray(inv)]
    return colors[:n_rays].reshape(camera.vsize, camera.hsize, 3)
