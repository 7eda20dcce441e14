"""Scenes, rays and configs shared by the traversal-kernel tests.

The kernel runs in the Pallas interpreter here (interpret=True, always by
explicit argument); the same code compiles for the GPU through Triton
(tests/test_gpu.py runs it there)."""

import functools

import jax.numpy as jnp
import numpy as np

from rtc_tpu.models.scenes import (REGISTRY, _cam, cow_herd_world,
                                   teapot_world)
from rtc_tpu.ops import transforms as X
from rtc_tpu.render import integrator
from rtc_tpu.render.camera import camera_rays
from rtc_tpu.scene.compile import compile_scene
from rtc_tpu.scene.materials import Material
from rtc_tpu.scene.shapes import cube, plane, sphere
from rtc_tpu.utils.config import RenderConfig
from rtc_tpu.utils.constants import BIG

BRUTE = RenderConfig(dtype="float32", ray_tile=512, mesh_impl="bruteforce")
KERNEL = RenderConfig(dtype="float32", ray_tile=512, mesh_impl="triton",
                      interpret=True)

# every scene class the kernel serves: flat, smooth, refractive (mesh +
# analytic floor), a 3x3 herd on the flat world table (52k triangles),
# its smooth variant, and a mesh mixed with several analytic kinds
SCENES = ("teapot", "teapot_smooth", "glass_teapot", "herd", "herd_smooth",
          "mixed")


def mixed_world():
    w = teapot_world()
    w.objects += [
        sphere(transform=X.translation(2.5, 0.0, -1.0),
               material=Material(color=(0.8, 0.2, 0.2), reflective=0.4)),
        cube(transform=X.translation(-2.8, -0.5, 0.5),
             material=Material(color=(0.2, 0.3, 0.9))),
        plane(transform=X.translation(0, -1.5, 0),
              material=Material(color=(0.6, 0.6, 0.6), reflective=0.2)),
    ]
    return w


def world_and_camera(name: str, width: int):
    if name == "herd":
        return cow_herd_world(3, 3), _cam(width, [0, 10, -18], [0, 3, 2])
    if name == "herd_smooth":
        return (cow_herd_world(3, 3, smooth=True),
                _cam(width, [0, 10, -18], [0, 3, 2]))
    if name == "mixed":
        return mixed_world(), _cam(width, [0, 4, -12], [0, 0, 0])
    return REGISTRY[name](width)


def rays_for(cam, dtype=jnp.float32):
    return camera_rays(
        jnp.asarray(cam.transform_inverse, dtype), cam.hsize, cam.vsize,
        jnp.asarray(cam.half_width, dtype),
        jnp.asarray(cam.half_height, dtype),
        jnp.asarray(cam.pixel_size, dtype), dtype)


@functools.lru_cache(maxsize=None)
def case(name: str, width: int = 32):
    """(scene, camera, o, d) for a named case, compiled once per process."""
    world, cam = world_and_camera(name, width)
    scene = compile_scene(world, dtype=np.float32)
    o, d = rays_for(cam)
    return scene, cam, o, d


def incoherent_rays(scene, o, d):
    """A reflection-shaped wavefront: origins just off the mesh surface,
    directions mirrored about the surface normals; misses are parked far
    away pointing outward, as the integrator parks dead lanes."""
    t, i = integrator.mesh_closest(scene, o, d, BRUTE)
    valid = jnp.asarray(np.asarray(t) < BIG / 2)
    t_safe = jnp.where(valid, t, 1.0)
    p = o + d * t_safe[:, None]
    n = scene.tri_n[i]
    refl = d - 2.0 * jnp.sum(d * n, axis=1, keepdims=True) * n
    far = jnp.asarray(1e12, o.dtype)
    o2 = jnp.where(valid[:, None], p + n * 1e-4, far)
    d2 = jnp.where(valid[:, None], refl, 0.5773502692)
    return o2, d2, valid


def assert_closest_parity(scene, o, d, cfg=KERNEL, atol=1e-5):
    """Kernel vs brute force: equal hit masks, |dt| <= atol, and winners
    that differ only at ties."""
    t_b, i_b = map(np.asarray, integrator.mesh_closest(scene, o, d, BRUTE))
    t_k, i_k = map(np.asarray, integrator.mesh_closest(scene, o, d, cfg))
    hit_b, hit_k = t_b < BIG / 2, t_k < BIG / 2
    np.testing.assert_array_equal(hit_b, hit_k)
    np.testing.assert_allclose(t_k[hit_k], t_b[hit_b], rtol=0, atol=atol)
    differ = hit_k & (i_k != i_b)
    assert (np.abs(t_k - t_b)[differ] <= atol).all()
    return hit_b
