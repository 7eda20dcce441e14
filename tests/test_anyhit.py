"""Any-hit shadow kernel vs closest-hit shadow semantics."""

import numpy as np
import jax.numpy as jnp

from rtc_tpu.models.scenes import REGISTRY
from rtc_tpu.render import integrator
from rtc_tpu.render.camera import camera_rays
from rtc_tpu.render.renderer import render
from rtc_tpu.scene.compile import compile_scene
from rtc_tpu.utils.config import RenderConfig


def test_anyhit_shadow_matches_closest_hit_shadow():
    world, cam = REGISTRY["teapot"](32)
    scene = compile_scene(world, dtype=np.float32)
    o, d = camera_rays(
        jnp.asarray(cam.transform_inverse, jnp.float32),
        cam.hsize, cam.vsize,
        jnp.asarray(cam.half_width, jnp.float32),
        jnp.asarray(cam.half_height, jnp.float32),
        jnp.asarray(cam.pixel_size, jnp.float32), jnp.float32)
    # shadow-test the primary hit points
    cfg_b = RenderConfig(dtype="float32", mesh_impl="bruteforce")
    cfg_p = RenderConfig(dtype="float32", mesh_impl="triton", interpret=True)
    hit = integrator.closest_hit(scene, o, d, cfg_b)
    t_safe = jnp.where(hit.valid, hit.t, 1.0)
    pts = o + d * t_safe[:, None]
    sh_b = np.asarray(integrator.is_shadowed(scene, pts, cfg_b))
    sh_p = np.asarray(integrator.is_shadowed(scene, pts, cfg_p))
    valid = np.asarray(hit.valid)
    agree = (sh_b == sh_p)[valid]
    assert agree.mean() > 0.995  # knife-edge self-shadow ties only


def test_full_render_with_anyhit_matches(teapot_width=28):
    world, cam = REGISTRY["teapot"](teapot_width)
    scene = compile_scene(world, dtype=np.float32)
    img_b = np.asarray(render(scene, cam, RenderConfig(
        dtype="float32", ray_tile=512, mesh_impl="bruteforce")))
    img_p = np.asarray(render(scene, cam, RenderConfig(
        dtype="float32", ray_tile=512, mesh_impl="triton", interpret=True)))
    diff = np.max(np.abs(img_b - img_p), axis=-1)
    assert (diff > 1e-4).mean() < 0.01
