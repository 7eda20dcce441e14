"""Progressive tile rendering with checkpoint/resume.

The reference has no persistence beyond the final PPM write (SURVEY.md §5).
Because a render here is a pure function of (scene, camera, config), tiles
are idempotent work units: finished tile rows are persisted and a crashed or
preempted render resumes from the last checkpoint. This is the render-side
analogue of step checkpointing in a training loop.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.compile import Scene
from ..utils.config import DEFAULT_CONFIG, RenderConfig
from . import integrator
from .camera import Camera, camera_rays
from .renderer import tile_rays


@partial(jax.jit, static_argnames=("cfg",))
def _tile_colors(scene: Scene, o, d, cfg: RenderConfig):
    return integrator.color_at(scene, o, d, cfg)


def render_tiles(scene: Scene, camera: Camera, cfg: RenderConfig = DEFAULT_CONFIG,
                 start_tile: int = 0) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Yield (tile_index, n_tiles, colors (tile, 3)) row-major, one device
    round-trip per tile. Deterministic: tile i is identical across runs."""
    dtype = cfg.jnp_dtype()
    o, d = camera_rays(
        jnp.asarray(camera.transform_inverse, dtype),
        camera.hsize, camera.vsize,
        jnp.asarray(camera.half_width, dtype),
        jnp.asarray(camera.half_height, dtype),
        jnp.asarray(camera.pixel_size, dtype), dtype)
    n_rays = o.shape[0]
    tile = tile_rays(scene, cfg, n_rays)
    n_tiles = -(-n_rays // tile)
    pad = n_tiles * tile - n_rays
    o = jnp.pad(o, ((0, pad), (0, 0)))
    d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    for i in range(start_tile, n_tiles):
        colors = _tile_colors(scene, o[i * tile:(i + 1) * tile],
                              d[i * tile:(i + 1) * tile], cfg)
        yield i, n_tiles, np.asarray(colors)


def render_with_checkpoints(scene: Scene, camera: Camera,
                            cfg: RenderConfig = DEFAULT_CONFIG,
                            checkpoint_path: Optional[str] = None,
                            checkpoint_every: int = 8) -> np.ndarray:
    """Render tile-by-tile, persisting progress; resumes automatically if
    `checkpoint_path` holds a partial render for the same shape."""
    n_rays = camera.hsize * camera.vsize
    tile = tile_rays(scene, cfg, n_rays)
    n_tiles = -(-n_rays // tile)
    flat = np.zeros((n_tiles * tile, 3), dtype=np.float64)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if ck["flat"].shape == flat.shape and int(ck["tile"]) == tile:
            flat = ck["flat"]
            start = int(ck["next_tile"])
    for i, total, colors in render_tiles(scene, camera, cfg, start_tile=start):
        flat[i * tile:(i + 1) * tile] = colors
        if checkpoint_path and ((i + 1) % checkpoint_every == 0 or i + 1 == total):
            np.savez(checkpoint_path, flat=flat, next_tile=i + 1, tile=tile)
    return flat[:n_rays].reshape(camera.vsize, camera.hsize, 3)
