"""Device-mesh construction for sharded rendering.

The scaling axes of a ray tracer (SURVEY.md §2):
  * 'rays'  — the pixel/ray wavefront: embarrassingly parallel, the
              data-parallel axis; always sharded.
  * 'prims' — the primitive/triangle table: the tensor-parallel axis for
              scenes too large to replicate; per-device partial closest-hits
              combine with a min-reduction across devices.

The reference has no parallelism at all (single-threaded pixel loop,
src/camera.rs:70-76); this module is new capability.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_rays: Optional[int] = None, n_prims: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('rays', 'prims') mesh. Defaults to all devices on the rays
    axis. n_rays * n_prims must equal the device count used."""
    devices = list(devices if devices is not None else jax.devices())
    if n_rays is None:
        n_rays = len(devices) // n_prims
    assert n_rays * n_prims == len(devices), (
        f"mesh {n_rays}x{n_prims} != {len(devices)} devices")
    arr = np.asarray(devices).reshape(n_rays, n_prims)
    return Mesh(arr, axis_names=("rays", "prims"))


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1, devices=jax.devices()[:1])
