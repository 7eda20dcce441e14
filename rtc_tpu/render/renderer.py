"""Top-level render loop: camera -> tiled wavefronts -> image.

Replaces the reference's scalar double loop (src/camera.rs:67-79) with a
single jitted program: ray-gen, then `lax.map` over fixed-size ray tiles so
the (rays x triangles) working set stays bounded in HBM regardless of
resolution. One compilation per (scene shape, canvas shape, config).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..scene.compile import Scene
from ..utils.config import DEFAULT_CONFIG, RenderConfig
from . import integrator
from .camera import Camera


@jax.jit
def _gen_rays(cam_inv, half_width, half_height, pixel_size, px, py):
    from .camera import camera_rays_for_pixels

    return camera_rays_for_pixels(cam_inv, px, py, half_width, half_height,
                                  pixel_size, cam_inv.dtype)


# A dense (rays x triangles) jnp sweep holds about 26 B per ray-triangle
# pair at its peak (10.19 GB for 65,536 rays x 5,888 rows, the brute-force
# cow on the GPU, PERF.md). A tile may fill a quarter of the device's
# memory; a device that reports no limit (the host) gets HOST_DENSE_PAIRS.
BYTES_PER_PAIR = 26
HOST_DENSE_PAIRS = 1 << 26


def dense_pairs() -> int:
    """Ray x triangle pairs one tile of a dense sweep may hold."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return limit // (4 * BYTES_PER_PAIR) if limit else HOST_DENSE_PAIRS


def tile_rays(scene: Scene, cfg: RenderConfig, n_rays: int) -> int:
    """Rays per wavefront tile: cfg.ray_tile when set. Otherwise the whole
    wavefront (fastest on the traversal-kernel path, PERF.md), unless a
    dense jnp sweep must fit the device: the brute-force search over every
    triangle, or the refraction census over the refractive meshes' rows.
    Then the largest power of two (at least 128) whose sweep stays within
    dense_pairs()."""
    if cfg.ray_tile:
        return min(cfg.ray_tile, n_rays)
    km, tm = scene.refr_tri_p1.shape[:2]
    dense = km * tm
    if scene.static.n_tris and integrator._resolve_mesh_impl(
            scene, cfg, cfg.jnp_dtype()) != "triton":
        dense += scene.static.n_tris
    if not dense:
        return n_rays
    budget = dense_pairs()
    tile = 128
    while tile * 2 * dense <= budget:
        tile *= 2
    return min(n_rays, tile)


@partial(jax.jit, static_argnames=("cfg",))
def _shade_rays(scene: Scene, o, d, cfg: RenderConfig):
    n_rays = o.shape[0]
    tile = tile_rays(scene, cfg, n_rays)
    n_tiles = -(-n_rays // tile)
    pad = n_tiles * tile - n_rays
    # pad rays park FAR outside every AABB (outward direction) so the
    # traversal schedules cull them instead of tracing them through the scene
    o = jnp.pad(o, ((0, pad), (0, 0)), constant_values=1e12)
    d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=0.5773502692)

    def one_tile(od):
        ot, dt = od
        # emit (3, tile): the map's stacked writes then have rays on the
        # contiguous minor dim
        return integrator.color_at(scene, ot, dt, cfg).T

    colors = jax.lax.map(
        one_tile, (o.reshape(n_tiles, tile, 3), d.reshape(n_tiles, tile, 3))
    )  # (n_tiles, 3, tile)
    return colors.transpose(0, 2, 1).reshape(-1, 3)[:n_rays]


@jax.jit
def _unpermute(colors, inv_perm):
    return colors[inv_perm]


BLOCK = 16  # 16x16 = 256-pixel screen blocks


def render(scene: Scene, camera: Camera, cfg: RenderConfig = DEFAULT_CONFIG):
    """Render to an (V, H, 3) image array (device).

    Coherent ordering: rays are GENERATED directly in tile order (elementwise
    from precomputed pixel-index constants — per-ray arithmetic is
    order-independent, so every ordering yields bit-identical pixel values).
    When the canvas divides into 16x16 blocks, pixels traverse block-major —
    each kernel ray block is a compact screen region (same footprint as a
    Morton tile) and the un-permute is a pure reshape/transpose, with no
    full-frame gather. Other sizes fall back to Morton order with a
    gathered un-permute.
    """
    dtype = cfg.jnp_dtype()
    morton = cfg.ray_order == "morton"
    blocked = morton and camera.vsize % BLOCK == 0 and camera.hsize % BLOCK == 0
    if blocked:
        px, py = _blocked_pixels(camera.vsize, camera.hsize)
        cfg = dataclasses.replace(cfg, ray_order="scanline")
    elif morton:
        _, inv_perm, px, py = _device_morton_perm(camera.vsize, camera.hsize)
        # the shading executable is order-independent; normalize the config
        # so both orders share one compilation cache entry
        cfg = dataclasses.replace(cfg, ray_order="scanline")
    else:
        px = jnp.tile(jnp.arange(camera.hsize, dtype=jnp.int32), camera.vsize)
        py = jnp.repeat(jnp.arange(camera.vsize, dtype=jnp.int32), camera.hsize)
    o, d = _gen_rays(
        jnp.asarray(camera.transform_inverse, dtype),
        jnp.asarray(camera.half_width, dtype),
        jnp.asarray(camera.half_height, dtype),
        jnp.asarray(camera.pixel_size, dtype),
        px, py,
    )
    colors = _shade_rays(scene, o, d, cfg)
    if blocked:
        return _unblock(colors, camera.vsize, camera.hsize)
    if morton:
        colors = _unpermute(colors, inv_perm)
    return colors.reshape(camera.vsize, camera.hsize, 3)


@partial(jax.jit, static_argnames=("vsize", "hsize"))
def _unblock(colors, vsize: int, hsize: int):
    """Block-major ray order -> row-major image: layout ops only."""
    vb, hb = vsize // BLOCK, hsize // BLOCK
    return (colors.reshape(vb, hb, BLOCK, BLOCK, 3)
            .transpose(0, 2, 1, 3, 4)
            .reshape(vsize, hsize, 3))


def _blocked_pixels(vsize: int, hsize: int):
    """Device-resident block-major pixel coordinates, cached per shape."""
    key = ("blocked", vsize, hsize)
    if key not in _PERM_CACHE:
        import numpy as np

        vb, hb = vsize // BLOCK, hsize // BLOCK
        iy, ix = np.meshgrid(np.arange(BLOCK), np.arange(BLOCK), indexing="ij")
        by, bx = np.meshgrid(np.arange(vb), np.arange(hb), indexing="ij")
        px = (bx[:, :, None, None] * BLOCK + ix[None, None]).ravel()
        py = (by[:, :, None, None] * BLOCK + iy[None, None]).ravel()
        _PERM_CACHE[key] = (jnp.asarray(px.astype(np.int32)),
                            jnp.asarray(py.astype(np.int32)))
    return _PERM_CACHE[key]


_PERM_CACHE: dict = {}


def _device_morton_perm(vsize: int, hsize: int):
    """Device-resident Morton permutation + Z-ordered pixel coordinates,
    cached per canvas shape (no host->device upload per frame)."""
    key = (vsize, hsize)
    if key not in _PERM_CACHE:
        import numpy as np

        from .order import morton_perm

        perm, inv_perm = morton_perm(vsize, hsize)
        px = (perm % hsize).astype(np.int32)
        py = (perm // hsize).astype(np.int32)
        _PERM_CACHE[key] = (jnp.asarray(perm), jnp.asarray(inv_perm),
                            jnp.asarray(px), jnp.asarray(py))
    return _PERM_CACHE[key]
