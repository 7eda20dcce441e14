"""Observability: render reports and timing.

The reference has no tracing/metrics at all (SURVEY.md §5); the closest thing
is the OBJ parser's ignored_lines counter. Here every render can emit a
structured report: rays cast per bounce level, wall time, rays/s — the
BASELINE.json primary metric.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, Optional

import jax


def bounce_levels(max_depth: int) -> int:
    """Number of shading levels the budget yields (see integrator docstring):
    each secondary ray costs 3 budget; a node shades iff its budget >= 1."""
    levels = 0
    b = max_depth
    while b >= 1:
        levels += 1
        b -= 3
    return levels


def rays_per_pixel(max_depth: int, any_reflective: bool, any_refractive: bool,
                   shadows: bool = True) -> int:
    """Ray casts per pixel in the wavefront integrator: each tree node costs
    1 closest-hit sweep + 1 shadow sweep; nodes branch 2-way per level when
    both reflect/refract subtrees are live."""
    levels = bounce_levels(max_depth)
    branch = (1 if any_reflective else 0) + (1 if any_refractive else 0)
    nodes = 0
    width = 1
    for _ in range(levels):
        nodes += width
        width *= max(branch, 1) if branch else 0
        if width == 0:
            break
    per_node = 2 if shadows else 1
    return max(nodes, 1) * per_node


@dataclasses.dataclass
class RenderReport:
    scene: str
    width: int
    height: int
    wall_s: float
    compile_s: float
    primary_rays: int
    total_ray_casts: int
    rays_per_s: float
    device: str
    dtype: str

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


@contextlib.contextmanager
def trace(logdir: str):
    """Device profiler trace around a render; view with TensorBoard or
    xprof. Usage:

        with profiling.trace("/tmp/trace"):
            img = render(scene, cam, cfg)
            jax.block_until_ready(img)
    """
    with jax.profiler.trace(logdir):
        yield


def annotate(name: str):
    """Named region for profiler timelines (jax.profiler.TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def timed(result: Dict[str, float], key: str):
    t0 = time.perf_counter()
    yield
    result[key] = time.perf_counter() - t0


def time_render(render_fn, *args, warmup: bool = True, iters: int = 1,
                **kwargs):
    """Return (result, compile_seconds, per_iter_seconds)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(render_fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0
    if not warmup:
        return out, compile_s, compile_s
    t1 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(render_fn(*args, **kwargs))
    per_iter = (time.perf_counter() - t1) / max(iters, 1)
    return out, compile_s, per_iter
