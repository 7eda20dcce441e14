"""Triton-route traversal kernels vs the brute-force sweep (Pallas
interpreter on the CPU; tests/test_gpu.py runs the compiled kernels on the
card)."""

import jax.numpy as jnp
import numpy as np
import pytest

from kernel_cases import (BRUTE, KERNEL, SCENES, assert_closest_parity,
                          case, incoherent_rays)
from rtc_tpu.ops.pallas import mesh_intersect as M
from rtc_tpu.render import integrator
from rtc_tpu.utils.constants import BIG


def _kernel_args(scene):
    return (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb)


@pytest.mark.parametrize("name", SCENES)
def test_pallas_matches_bruteforce(name):
    scene, _, o, d = case(name)
    hit = assert_closest_parity(scene, o, d)
    assert hit.any() and (~hit).any()


@pytest.mark.parametrize("name", SCENES)
def test_exact_schedule_matches_bruteforce_closest(name):
    """Incoherent secondary wavefronts (origins on the surface, mirrored
    directions, parked dead lanes) agree with brute force too."""
    scene, _, o, d = case(name)
    o2, d2, _ = incoherent_rays(scene, o, d)
    assert_closest_parity(scene, o2, d2)


@pytest.mark.parametrize("name", SCENES)
def test_exact_schedule_anyhit_matches_bruteforce(name):
    scene, _, o, d = case(name)
    o2, _, live = incoherent_rays(scene, o, d)
    s_b = np.asarray(integrator.is_shadowed(scene, o2, BRUTE, live=live))
    s_k = np.asarray(integrator.is_shadowed(scene, o2, KERNEL, live=live))
    lv = np.asarray(live)
    # silhouette knife edges only (bench.py's on-card gate is the same)
    assert (s_b != s_k)[lv].sum() <= max(2, lv.size // 2048)
    assert not s_k[~lv].any()  # dead lanes report unshadowed


@pytest.mark.parametrize("block_rays", (32, 64, 256))
def test_schedule_is_tile_invariant(block_rays):
    """The block skips are per-program unions of per-ray box tests, so the
    block size changes WHICH boxes a program visits — but the winning
    (t, idx) per ray must be bitwise identical."""
    scene, _, o, d = case("teapot")
    kw = dict(leaf=scene.static.cluster_size, interpret=True)
    t_a, i_a = M.closest_hit(o, d, *_kernel_args(scene), block_rays=128, **kw)
    t_b, i_b = M.closest_hit(o, d, *_kernel_args(scene),
                             block_rays=block_rays, **kw)
    np.testing.assert_array_equal(np.asarray(i_a), np.asarray(i_b))
    np.testing.assert_array_equal(np.asarray(t_a), np.asarray(t_b))


@pytest.mark.parametrize("n_rays", (1, 77, 300))
def test_ragged_ray_count(n_rays):
    """Ray counts that are not a multiple of the block: padded rays never
    leak into the outputs, which have exactly R rows."""
    scene, _, o, d = case("teapot")
    sl = slice(200, 200 + n_rays)
    kw = dict(leaf=scene.static.cluster_size, interpret=True, block_rays=64)
    t, idx = M.closest_hit(o[sl], d[sl], *_kernel_args(scene), **kw)
    t_full, idx_full = M.closest_hit(o, d, *_kernel_args(scene), **kw)
    assert t.shape == (n_rays,) and idx.shape == (n_rays,)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(idx_full)[sl])
    hit = M.any_hit(o[sl], d[sl], jnp.full((n_rays,), 100.0),
                    *_kernel_args(scene), **kw)
    assert hit.shape == (n_rays,)
    np.testing.assert_array_equal(np.asarray(hit), np.asarray(idx) >= 0)


def test_parked_and_dead_lanes():
    """Parked lanes (far origin, outward direction — how the integrator
    retires dead secondary rays) miss; any-hit lanes with max_t <= 0 report
    False even when their ray would hit."""
    scene, _, o, d = case("teapot")
    kw = dict(leaf=scene.static.cluster_size, interpret=True)
    park_o = jnp.full_like(o, 1e12)
    park_d = jnp.full_like(d, 0.5773502692)
    t, idx = M.closest_hit(park_o, park_d, *_kernel_args(scene), **kw)
    assert (np.asarray(idx) == -1).all()
    assert (np.asarray(t) == BIG).all()
    _, idx_live = M.closest_hit(o, d, *_kernel_args(scene), **kw)
    assert (np.asarray(idx_live) >= 0).any()
    dead = M.any_hit(o, d, jnp.full(o.shape[:1], -1.0), *_kernel_args(scene),
                     **kw)
    assert not np.asarray(dead).any()
    live = M.any_hit(o, d, jnp.full(o.shape[:1], 100.0), *_kernel_args(scene),
                     **kw)
    np.testing.assert_array_equal(np.asarray(live), np.asarray(idx_live) >= 0)


def test_empty_clusters_are_never_visited():
    """Clusters with an empty box (lo > hi) are skipped even when their
    rows hold real triangles: the box table, not the rows, gates a visit."""
    scene, _, o, d = case("teapot")
    kw = dict(leaf=scene.static.cluster_size, interpret=True)
    empty = jnp.tile(jnp.asarray([[1.0, 1.0, 1.0, -1.0, -1.0, -1.0]]),
                     (scene.cluster_aabb.shape[0], 1))
    _, idx = M.closest_hit(o, d, scene.tri_p1, scene.tri_e1, scene.tri_e2,
                           empty, **kw)
    assert (np.asarray(idx) == -1).all()
