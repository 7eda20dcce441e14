"""End-to-end renders and gradients through the traversal kernel (Pallas
interpreter) against the brute-force path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kernel_cases import BRUTE, KERNEL, SCENES, case
from rtc_tpu.models.scenes import REGISTRY
from rtc_tpu.ops import intersect
from rtc_tpu.render import integrator
from rtc_tpu.render.renderer import render
from rtc_tpu.scene.compile import compile_scene
from rtc_tpu.utils.constants import BIG


@pytest.mark.parametrize("name", SCENES)
def test_pallas_render_matches_bruteforce(name):
    scene, cam, _, _ = case(name, 24)
    img_b = np.asarray(render(scene, cam, BRUTE))
    img_k = np.asarray(render(scene, cam, KERNEL))
    err = np.abs(img_b - img_k).max(axis=-1)
    # shadow/refraction knife edges may flip isolated pixels
    assert np.quantile(err, 0.99) < 2e-3 and (err > 0.05).sum() <= 2


def test_full_render_with_secondary_exact_schedule():
    """cow render (reflective mesh: secondary sweeps walk the boxes with
    incoherent rays) must match brute force end-to-end."""
    world, cam = REGISTRY["cow"](24)
    scene = compile_scene(world, dtype=np.float32)
    img_b = np.asarray(render(scene, cam, BRUTE))
    img_k = np.asarray(render(scene, cam, KERNEL))
    assert np.abs(img_b - img_k).max() < 2e-3


@pytest.mark.parametrize("name", SCENES)
def test_kernel_grad_matches_bruteforce(name):
    """The kernel only picks the winner; t is recomputed at it in jnp, so
    ray and vertex gradients equal those of the brute-force path."""
    scene, _, o, d = case(name)
    mid = o.shape[0] // 2
    o, d = o[mid:mid + 64], d[mid:mid + 64]

    def loss_fn(cfg):
        def loss(tri_p1, o, d):
            s = dataclasses.replace(scene, tri_p1=tri_p1)
            t, _ = integrator.mesh_closest(s, o, d, cfg)
            return jnp.sum(jnp.where(t < BIG / 2, t, 0.0))
        return loss

    gk = jax.grad(loss_fn(KERNEL), argnums=(0, 1, 2))(scene.tri_p1, o, d)
    gb = jax.grad(loss_fn(BRUTE), argnums=(0, 1, 2))(scene.tri_p1, o, d)
    for a, b in zip(gk, gb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-5)


def test_pallas_grad_flows_through_refinement():
    scene, _, o, d = case("teapot")
    mid = o.shape[0] // 2  # center rays hit the teapot
    o, d = o[mid:mid + 64], d[mid:mid + 64]

    def loss(tri_p1):
        s = dataclasses.replace(scene, tri_p1=tri_p1)
        t, _ = integrator.mesh_closest(s, o, d, KERNEL)
        return jnp.sum(jnp.where(t < BIG / 2, t, 0.0))

    g = np.asarray(jax.grad(loss)(scene.tri_p1))
    assert np.all(np.isfinite(g)) and np.abs(g).sum() > 0.0


def test_color_grad_matches_bruteforce():
    """Material gradients of a whole shaded frame agree across backends."""
    scene, _, o, d = case("teapot", 16)

    def loss(color, cfg):
        s = dataclasses.replace(scene, mat_color=color)
        return jnp.mean(integrator.color_at(s, o, d, cfg))

    gk = jax.grad(loss)(scene.mat_color, KERNEL)
    gb = jax.grad(loss)(scene.mat_color, BRUTE)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gb), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("name", ("teapot_smooth", "herd_smooth"))
def test_smooth_normal_matches_bruteforce(name):
    """Smooth meshes blend corner normals with the winner's (u, v) from the
    recompute; kernel and brute force must give the same shading normals."""
    scene, _, o, d = case(name)
    assert scene.static.any_smooth
    hit_k = integrator.closest_hit(scene, o, d, KERNEL)
    hit_b = integrator.closest_hit(scene, o, d, BRUTE)
    ok = np.asarray(hit_b.valid)
    np.testing.assert_array_equal(ok, np.asarray(hit_k.valid))
    same_tri = np.asarray(hit_k.tri)[ok] == np.asarray(hit_b.tri)[ok]
    err = np.abs(np.asarray(hit_k.tri_n)[ok]
                 - np.asarray(hit_b.tri_n)[ok]).max(axis=1)
    assert (err[same_tri] < 1e-5).all()


def test_herd_uses_flat_world_table():
    """Instanced herds compile to one flat, clustered world table: the
    kernel reads it from device memory, with no size budget."""
    scene, _, o, d = case("herd")
    st = scene.static
    assert st.n_tris == st.n_clusters * st.cluster_size >= 9 * 5804
    assert scene.cluster_aabb.shape == (st.n_clusters, 6)
    hit = integrator.closest_hit(scene, o, d, KERNEL)
    obj = np.asarray(hit.obj)[np.asarray(hit.valid)]
    assert len(np.unique(obj)) > 1  # several cows are hit


def test_recomputed_t_matches_sweep():
    """mesh_closest's t is the winner's Möller-Trumbore t, identical to the
    brute-force sweep's value at that triangle."""
    scene, _, o, d = case("teapot")
    t, idx = integrator.mesh_closest(scene, o, d, BRUTE)
    t_all, v_all, _, _ = intersect.triangle(
        o[:, None, :], d[:, None, :], scene.tri_p1[None], scene.tri_e1[None],
        scene.tri_e2[None], BRUTE.epsilon)
    tt = np.where(np.asarray(v_all) & (np.asarray(t_all) >= 0),
                  np.asarray(t_all), BIG)
    np.testing.assert_array_equal(np.asarray(idx)[tt.min(1) < BIG],
                                  tt.argmin(1)[tt.min(1) < BIG])
    np.testing.assert_allclose(np.asarray(t), tt.min(1), rtol=1e-6)
