"""Multi-chip sharding tests on the 8-device virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8). SURVEY.md §2 parallelism table:
rays = data parallel, primitive shards = tensor parallel with min-reduce."""

import numpy as np
import jax
import pytest

from rtc_tpu.models.scenes import REGISTRY
from rtc_tpu.parallel.mesh import make_mesh
from rtc_tpu.parallel.shard import pad_tris, render_sharded
from rtc_tpu.render.renderer import render
from rtc_tpu.scene.compile import compile_scene
from rtc_tpu.utils.config import RenderConfig

CFG = RenderConfig(ray_tile=1024, dtype="float32")


def assert_images_match(actual, expected, atol=1e-5, outlier_frac=0.002):
    """Golden-image comparison tolerating a small fraction of knife-edge
    pixels: scenes with checker patterns on y=0 planes flip floor() parity on
    1-ulp differences, so different-but-valid XLA fusions legitimately
    disagree on isolated boundary pixels. Measured: mesh scenes are exact to
    ~1 ulp under sharding; only three_spheres shows ~0.1% parity pixels."""
    diff = np.max(np.abs(np.asarray(actual) - np.asarray(expected)), axis=-1)
    frac = float((diff > atol).mean())
    assert frac <= outlier_frac, f"{frac:.2%} of pixels differ by > {atol}"


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax.devices()[:8]


def test_ray_sharded_render_matches_single_device(eight_devices):
    world, cam = REGISTRY["three_spheres"](64)
    scene = compile_scene(world, dtype=np.float32)
    img_ref = np.asarray(render(scene, cam, CFG))
    mesh = make_mesh(8, 1)
    img_sh = np.asarray(render_sharded(scene, cam, CFG, mesh=mesh))
    assert_images_match(img_sh, img_ref)


def test_prim_sharded_render_matches_single_device(eight_devices):
    world, cam = REGISTRY["teapot"](32)
    scene = compile_scene(world, dtype=np.float32)
    img_ref = np.asarray(render(scene, cam, RenderConfig(ray_tile=512)))
    mesh = make_mesh(4, 2)
    img_sh = np.asarray(
        render_sharded(scene, cam, RenderConfig(ray_tile=512), mesh=mesh,
                       shard_prims=True)
    )
    assert_images_match(img_sh, img_ref)


def test_pad_tris_never_hits(eight_devices):
    world, cam = REGISTRY["teapot"](16)
    scene = compile_scene(world, dtype=np.float32)
    padded = pad_tris(scene, 7)
    assert padded.static.n_tris % 7 == 0
    img_ref = np.asarray(render(scene, cam, RenderConfig(ray_tile=256)))
    img_pad = np.asarray(render(padded, cam, RenderConfig(ray_tile=256)))
    assert_images_match(img_pad, img_ref, atol=1e-6, outlier_frac=0.0)


def test_full_2d_mesh_with_reflection_scene(eight_devices):
    world, cam = REGISTRY["glass_spheres"](48)
    scene = compile_scene(world, dtype=np.float32)
    img_ref = np.asarray(render(scene, cam, CFG))
    mesh = make_mesh(2, 4)
    img_sh = np.asarray(render_sharded(scene, cam, CFG, mesh=mesh, shard_prims=True))
    assert_images_match(img_sh, img_ref)


def test_prim_sharded_kernel_matches_single_device(eight_devices):
    """Tensor-parallel triangle sharding with the traversal kernel running
    per shard (local cluster tables + min-by-t / psum-OR reductions), on
    the 8 virtual devices."""
    world, cam = REGISTRY["teapot"](32)
    scene = compile_scene(world, dtype=np.float32)
    cfg = RenderConfig(ray_tile=512, mesh_impl="triton", interpret=True)
    img_ref = np.asarray(render(scene, cam, cfg))
    mesh = make_mesh(2, 4)
    img_sh = np.asarray(
        render_sharded(scene, cam, cfg, mesh=mesh, shard_prims=True))
    assert_images_match(img_sh, img_ref)
