"""Render configuration.

The reference hardcodes its knobs: recursion depth (src/world.rs:11), canvas size
(src/main.rs:77,329), epsilon (src/utils.rs:2). Here they are a single dataclass
that is hashable (so it can be a static jit argument).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .constants import EPSILON


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for a render.

    Attributes:
      max_depth: recursion budget, semantics identical to the reference's
        RECURSION_LIMIT (src/world.rs:11): a budget of 5 yields two shading
        levels (primary + one secondary reflect/refract pair).
      epsilon: offset for over/under points and parallel-ray guards.
      dtype: 'float32' or 'float64' (name, to stay hashable).
      ray_tile: rays per wavefront tile; the renderer maps over tiles to bound
        the (rays x triangles) working set in device memory. None (the
        default) lets the renderer choose from the scene, the triangle
        search and the ray count (renderer.tile_rays).
      mesh_impl: triangle search: 'auto' | 'bruteforce' | 'triton'.
        'bruteforce' is the dense jnp sweep; 'triton' the cluster-traversal
        kernel (ops/pallas/mesh_intersect.py). 'auto' picks brute force on
        the CPU and in float64, the kernel on the GPU, and raises on any
        other platform (integrator._resolve_mesh_impl).
      interpret: run the 'triton' kernel in the Pallas interpreter (CPU
        tests); never chosen implicitly.
      shadows: enable shadow rays (reference always does).
      ray_order: 'morton' renders pixels in Z-order (compact screen tiles ->
        tighter wavefront coherence for the cluster cull); 'scanline' is the
        reference's traversal. Pure permutation, identical output.
      prim_axis: mesh axis name the triangle table is sharded over (set by
        parallel.shard inside shard_map; None = replicated scene).
    """

    max_depth: int = 5
    epsilon: float = EPSILON
    dtype: str = "float32"
    ray_tile: Optional[int] = None
    mesh_impl: str = "auto"
    interpret: bool = False
    shadows: bool = True
    ray_order: str = "morton"
    prim_axis: Optional[str] = None

    def jnp_dtype(self):
        import jax.numpy as jnp

        return jnp.dtype(self.dtype)


DEFAULT_CONFIG = RenderConfig()
