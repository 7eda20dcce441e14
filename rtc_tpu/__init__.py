"""rtc_tpu — a differentiable ray-tracing framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
`antoinehebert/ray-tracer-challenge-rust` (the complete "Ray Tracer
Challenge" Whitted ray tracer): every primitive, pattern, material feature,
the full reflection/refraction integrator, OBJ meshes, and the four shipped
scenes — rebuilt as a differentiable wavefront renderer over SoA scene slabs,
sharded across device meshes with `shard_map`.

Layer map (SURVEY.md §1):
  ops/      numeric core + per-kind kernels        (reference L0-L2)
  scene/    builder API + SoA compiler             (reference shape/world ctors)
  render/   camera, wavefront integrator, renderer (reference L3)
  io/       OBJ parser, PPM canvas                 (reference L4)
  models/   the shipped scenes                     (reference L5)
  parallel/ device-mesh sharding of rays/primitives (no reference equivalent)
"""

from .scene.materials import (  # noqa: F401
    Material,
    Pattern,
    checkers_pattern,
    gradient_pattern,
    ring_pattern,
    stripe_pattern,
    test_pattern,
)
from .scene.shapes import (  # noqa: F401
    cone,
    cube,
    cylinder,
    glass_sphere,
    group,
    infinite_cone,
    infinite_cylinder,
    mesh,
    plane,
    sphere,
    triangle,
)
from .scene.world import PointLight, World, default_world  # noqa: F401
from .scene.compile import Scene, compile_scene  # noqa: F401
from .render.camera import Camera  # noqa: F401
from .render.renderer import render  # noqa: F401
from .render.integrator import (  # noqa: F401
    Intersections,
    color_at,
    hit_index,
    intersect_all,
)
from .io.canvas import Canvas, write_ppm  # noqa: F401
from .utils.config import DEFAULT_CONFIG, RenderConfig  # noqa: F401

__version__ = "0.1.0"
