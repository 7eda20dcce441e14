"""The traversal kernels compiled for the GPU (Pallas, Triton route) against
brute force. A compiled Triton kernel has no CPU path, so these tests skip
without a card; chip_smoke.py phase (h) runs them on the card:

    RTC_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_gpu.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kernel_cases import (BRUTE, KERNEL, assert_closest_parity, case,
                          incoherent_rays)
from rtc_tpu.ops.pallas import mesh_intersect as M
from rtc_tpu.render import integrator
from rtc_tpu.render.renderer import render
from rtc_tpu.utils.constants import BIG

pytestmark = pytest.mark.gpu

COMPILED = dataclasses.replace(KERNEL, interpret=False)


@pytest.fixture(scope="module")
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: compiled Triton kernels only run "
                    "there (the CPU tests cover them in interpret mode)")


# widths keep the dense brute-force reference's (rays, triangles, 3)
# intermediates within the card: the herd has 9x the cow's triangles
WIDTH = {"herd": 64}


@pytest.mark.parametrize("name", ("cow", "teapot_smooth", "glass_teapot",
                                  "herd", "mixed"))
def test_gpu_closest_matches_bruteforce(gpu, name):
    scene, _, o, d = case(name, WIDTH.get(name, 256))
    assert_closest_parity(scene, o, d, COMPILED, atol=1e-4)
    o2, d2, _ = incoherent_rays(scene, o, d)
    assert_closest_parity(scene, o2, d2, COMPILED, atol=1e-4)


@pytest.mark.parametrize("name", ("cow", "herd"))
def test_gpu_anyhit_matches_bruteforce(gpu, name):
    scene, _, o, d = case(name, WIDTH.get(name, 256))
    o2, _, live = incoherent_rays(scene, o, d)
    s_b = np.asarray(integrator.is_shadowed(scene, o2, BRUTE, live=live))
    s_k = np.asarray(integrator.is_shadowed(scene, o2, COMPILED, live=live))
    assert (s_b != s_k).sum() <= max(2, s_b.size // 2048)


def test_gpu_matches_interpreter(gpu):
    """The compiled kernel and the Pallas interpreter pick the same
    winners: the Triton lowering preserves the kernel's semantics."""
    scene, _, o, d = case("teapot", 64)
    args = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb)
    kw = dict(leaf=scene.static.cluster_size)
    t_c, i_c = M.closest_hit(o, d, *args, **kw)
    t_i, i_i = M.closest_hit(o, d, *args, interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(i_c), np.asarray(i_i))
    np.testing.assert_allclose(np.asarray(t_c), np.asarray(t_i), atol=1e-5)


@pytest.mark.parametrize("block_rays", (32, 64, 256))
def test_gpu_block_size_invariance(gpu, block_rays):
    scene, _, o, d = case("cow", 256)
    args = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb)
    kw = dict(leaf=scene.static.cluster_size)
    _, i_a = M.closest_hit(o, d, *args, **kw)
    _, i_b = M.closest_hit(o, d, *args, block_rays=block_rays, **kw)
    np.testing.assert_array_equal(np.asarray(i_a), np.asarray(i_b))


def test_gpu_ragged_and_dead_lanes(gpu):
    scene, _, o, d = case("cow", 64)
    args = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb)
    kw = dict(leaf=scene.static.cluster_size)
    t, idx = M.closest_hit(o[:77], d[:77], *args, **kw)
    _, idx_full = M.closest_hit(o, d, *args, **kw)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(idx_full)[:77])
    dead = M.any_hit(o, d, jnp.full(o.shape[:1], -1.0), *args, **kw)
    assert not np.asarray(dead).any()


def test_gpu_grad_matches_bruteforce(gpu):
    scene, _, o, d = case("cow", 64)
    mid = o.shape[0] // 2
    o, d = o[mid:mid + 256], d[mid:mid + 256]

    def loss_fn(cfg):
        def loss(tri_p1, o, d):
            s = dataclasses.replace(scene, tri_p1=tri_p1)
            t, _ = integrator.mesh_closest(s, o, d, cfg)
            return jnp.sum(jnp.where(t < BIG / 2, t, 0.0))
        return loss

    gk = jax.grad(loss_fn(COMPILED), argnums=(0, 1, 2))(scene.tri_p1, o, d)
    gb = jax.grad(loss_fn(BRUTE), argnums=(0, 1, 2))(scene.tri_p1, o, d)
    for a, b in zip(gk, gb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ("teapot_smooth", "glass_teapot", "mixed"))
def test_gpu_render_matches_bruteforce(gpu, name):
    scene, cam, _, _ = case(name, 128)
    img_b = np.asarray(render(scene, cam, BRUTE))
    img_k = np.asarray(render(scene, cam, COMPILED))
    err = np.abs(img_b - img_k).max(axis=-1)
    assert np.quantile(err, 0.99) < 2e-3 and (err > 0.05).sum() <= 4
