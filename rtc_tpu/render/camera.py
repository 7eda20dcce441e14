"""Camera + vectorized primary-ray generation (reference: src/camera.rs).

`ray_for_pixel` (src/camera.rs:48-65) becomes one batched computation over the
whole pixel grid: two mat-vecs and a normalize per pixel, fused by XLA.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

# full f32 precision: XLA may otherwise contract f32 in TF32 on the GPU
_HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass
class Camera:
    hsize: int
    vsize: int
    field_of_view: float
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )

    def __post_init__(self):
        # half extents / pixel size (reference: src/camera.rs:16-41)
        half_view = math.tan(self.field_of_view / 2.0)
        aspect = self.hsize / self.vsize
        if aspect >= 1.0:
            self.half_width = half_view
            self.half_height = half_view / aspect
        else:
            self.half_width = half_view * aspect
            self.half_height = half_view
        self.pixel_size = self.half_width * 2.0 / self.hsize

    def set_transform(self, m) -> "Camera":
        """(reference: src/camera.rs:43-46)"""
        self.transform = np.asarray(m, dtype=np.float64).reshape(4, 4)
        return self

    @property
    def transform_inverse(self) -> np.ndarray:
        return np.linalg.inv(self.transform)


def camera_rays_for_pixels(inv, px, py, half_width, half_height, pixel_size,
                           dtype=jnp.float32):
    """Primary rays for explicit pixel coordinates px/py ((R,) integer
    arrays) — ray_for_pixel (src/camera.rs:48-65) batched over any pixel
    ORDER. Rendering in Morton order generates rays directly in that order
    (pure elementwise — no runtime permutation gather); per-pixel arithmetic
    is identical for every ordering, so orders differ only by permutation.

    Kept traceable so camera pose can be differentiated through.
    """
    inv = jnp.asarray(inv, dtype=dtype)
    wx = half_width - (px.astype(dtype) + 0.5) * pixel_size  # +x is LEFT
    wy = half_height - (py.astype(dtype) + 0.5) * pixel_size
    pix = jnp.stack(
        [wx, wy, jnp.full_like(wx, -1.0), jnp.ones_like(wx)], axis=-1
    )  # canvas plane z = -1 (src/camera.rs:60)
    pixel_world = jnp.einsum("ij,rj->ri", inv, pix,
                             precision=_HIGHEST)[..., :3]
    origin = inv[:3, 3]  # inv @ (0, 0, 0, 1)
    direction = pixel_world - origin
    norm = jnp.sqrt(jnp.sum(direction * direction, axis=-1, keepdims=True))
    direction = direction / jnp.maximum(norm, 1e-30)
    origins = jnp.broadcast_to(origin, direction.shape)
    return origins, direction


def camera_rays(inv, hsize: int, vsize: int, half_width, half_height, pixel_size,
                dtype=jnp.float32):
    """All primary rays, row-major like the reference's y/x loop
    (src/camera.rs:67-79). inv: (4, 4) camera inverse. Returns (R, 3) x 2."""
    xx = jnp.tile(jnp.arange(hsize, dtype=jnp.int32), vsize)
    yy = jnp.repeat(jnp.arange(vsize, dtype=jnp.int32), hsize)
    return camera_rays_for_pixels(inv, xx, yy, half_width, half_height,
                                  pixel_size, dtype)
