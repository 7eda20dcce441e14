"""Backend choice per platform, the kernel wrapper's tables, and the
kernels' lowering for the GPU (checked here without a card)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kernel_cases import BRUTE, KERNEL, case
from rtc_tpu.ops.pallas import mesh_intersect as M
from rtc_tpu.render import integrator
from rtc_tpu.utils.config import RenderConfig


@pytest.mark.parametrize("platform,dtype,expected", [
    ("cpu", jnp.float32, "bruteforce"),
    ("gpu", jnp.float32, "triton"),
    ("gpu", jnp.float64, "bruteforce"),
])
def test_auto_resolves_per_platform(monkeypatch, platform, dtype, expected):
    scene, _, _, _ = case("teapot")
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert integrator._resolve_mesh_impl(scene, RenderConfig(), dtype) \
        == expected


@pytest.mark.parametrize("platform", ("rocm", "metal"))
def test_auto_raises_on_other_platform(monkeypatch, platform):
    scene, _, _, _ = case("teapot")
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(ValueError, match="no triangle search"):
        integrator._resolve_mesh_impl(scene, RenderConfig(), jnp.float32)


@pytest.mark.parametrize("name", ("mxu", "pallas", "mxu_interpret",
                                  "pallas_interpret"))
def test_removed_mesh_impls_raise(name):
    scene, _, o, d = case("teapot")
    cfg = RenderConfig(mesh_impl=name)
    with pytest.raises(ValueError, match="mesh_impl must be one of"):
        integrator.mesh_closest(scene, o, d, cfg)


def test_explicit_choices_are_kept():
    """An explicit choice is never rewritten to another backend, and the
    interpreter is used only when asked for."""
    scene, _, _, _ = case("teapot")
    for cfg in (BRUTE, KERNEL):
        assert integrator._resolve_mesh_impl(scene, cfg, jnp.float32) \
            == cfg.mesh_impl
    assert RenderConfig().interpret is False
    assert not hasattr(RenderConfig(), "fused_shadow")


def test_triton_without_clusters_uses_bruteforce():
    from rtc_tpu.scene.compile import compile_scene
    from kernel_cases import world_and_camera

    world, _ = world_and_camera("teapot", 8)
    scene = compile_scene(world, dtype=np.float32, cluster_size=0)
    assert scene.static.n_clusters == 0
    assert integrator._resolve_mesh_impl(scene, KERNEL, jnp.float32) \
        == "bruteforce"


def test_bruteforce_search_breaks_ties_to_lowest_row():
    """Two coincident triangles: the brute-force search reports the lower
    row, and so does the kernel (ascending visit order, strict '<')."""
    scene, _, o, d = case("teapot")
    dup = dataclasses.replace(
        scene,
        tri_p1=scene.tri_p1.at[1].set(scene.tri_p1[0]),
        tri_e1=scene.tri_e1.at[1].set(scene.tri_e1[0]),
        tri_e2=scene.tri_e2.at[1].set(scene.tri_e2[0]))
    # aim one ray at triangle 0's centroid
    c = dup.tri_p1[0] + (dup.tri_e1[0] + dup.tri_e2[0]) / 3.0
    o1 = c[None, :] + jnp.asarray([[0.0, 0.0, -5.0]])
    d1 = jnp.asarray([[0.0, 0.0, 1.0]])
    for cfg in (BRUTE, KERNEL):
        hit, idx = integrator.mesh_search(dup, o1, d1, cfg)
        assert bool(hit[0])
        # the winner is the lower of the coincident pair, or a triangle in
        # front of both
        assert int(idx[0]) != 1


def test_box_tables_pad_and_flag():
    boxes = jnp.asarray([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0],
                         [1.0, 1.0, 1.0, -1.0, -1.0, -1.0],     # empty
                         [2.0, -1.0, 0.0, 3.0, 0.0, 0.0]])      # flat in z
    sbox, box = M.box_tables(boxes)
    box = np.asarray(box).reshape(-1, 8)
    sbox = np.asarray(sbox).reshape(-1, 8)
    assert box.shape == (M.SUPER_WIDTH, 8) and sbox.shape == (1, 8)
    np.testing.assert_array_equal(box[:, 6], [1, 0, 1] + [0] * 5)
    # real boxes are widened (never narrowed), flat ones get a thickness
    assert (box[0, :3] < 0).all() and (box[0, 3:6] > 1).all()
    assert box[2, 5] > box[2, 2]
    # the group box is the union of the VALID member boxes only
    np.testing.assert_allclose(sbox[0, :3], box[[0, 2], :3].min(0))
    np.testing.assert_allclose(sbox[0, 3:6], box[[0, 2], 3:6].max(0))
    assert sbox[0, 6] == 1


def test_ray_table_layout():
    o = jnp.arange(15.0).reshape(5, 3)
    d = jnp.ones((5, 3))
    rays = np.asarray(M._ray_table(o, d, jnp.arange(5.0), 4))
    assert rays.shape == (8, 8)
    np.testing.assert_array_equal(rays[0:3, :5], np.asarray(o).T)
    np.testing.assert_array_equal(rays[6, :5], np.arange(5.0))
    # padded rays start at BIG (no box overlap) and can never report a hit
    assert (rays[0:3, 5:] >= 1e30).all() and (rays[6, 5:] == -1.0).all()


@pytest.mark.parametrize("kernel", ("closest", "any"))
def test_kernel_lowers_for_cuda(kernel):
    """Each kernel lowers through Pallas' Triton route for the GPU: the
    program carries a Triton custom call and no interpreter loop."""
    scene, _, o, d = case("teapot")
    args = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb)
    kw = dict(leaf=scene.static.cluster_size)
    if kernel == "closest":
        fn = lambda o, d: M.closest_hit(o, d, *args, **kw)
    else:
        fn = lambda o, d: M.any_hit(o, d, jnp.ones(o.shape[:1]), *args, **kw)
    text = jax.jit(fn).trace(o, d).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


def test_interpret_flag_reaches_kernel(monkeypatch):
    """cfg.interpret is passed through to the kernel call unchanged."""
    seen = {}
    real = M.closest_hit

    def spy(*args, **kw):
        seen["interpret"] = kw["interpret"]
        return real(*args, **kw)

    monkeypatch.setattr(M, "closest_hit", spy)
    scene, _, o, d = case("teapot")
    integrator.mesh_search(scene, o[:8], d[:8], KERNEL)
    assert seen["interpret"] is True
    cfg = dataclasses.replace(KERNEL, interpret=False)
    with pytest.raises(Exception):
        # compiled kernels need the GPU: no silent fallback on the CPU
        integrator.mesh_search(scene, o[:8], d[:8], cfg)
    assert seen["interpret"] is False


@pytest.mark.parametrize("name,cfg,n_rays,budget,expected", [
    # an explicit tile is kept, clipped to the wavefront
    ("teapot", KERNEL, 2048, 1 << 26, 512),
    ("teapot", KERNEL, 300, 1 << 26, 300),
    # the kernel path without refraction: the whole wavefront, one tile
    ("teapot", dataclasses.replace(KERNEL, ray_tile=None), 1 << 21, 1 << 26,
     1 << 21),
    # brute force: the largest power of two whose (rays x rows) sweep fits
    ("teapot", dataclasses.replace(BRUTE, ray_tile=None), 1 << 21, 1 << 26,
     None),
    # the refraction census bounds the kernel path too
    ("glass_teapot", dataclasses.replace(KERNEL, ray_tile=None), 1 << 21,
     1 << 26, None),
    # a budget below one minimum tile still gives 128 rays
    ("teapot", dataclasses.replace(BRUTE, ray_tile=None), 1 << 21, 1, 128),
    # a wavefront smaller than the tile is taken whole
    ("teapot", dataclasses.replace(BRUTE, ray_tile=None), 200, 1 << 26, 200),
])
def test_tile_rays_policy(monkeypatch, name, cfg, n_rays, budget, expected):
    from rtc_tpu.render import renderer

    scene, _, _, _ = case(name)
    monkeypatch.setattr(renderer, "dense_pairs", lambda: budget)
    tile = renderer.tile_rays(scene, cfg, n_rays)
    if expected is not None:
        assert tile == expected
        return
    km, tm = scene.refr_tri_p1.shape[:2]
    dense = km * tm + (scene.static.n_tris
                       if cfg.mesh_impl == "bruteforce" else 0)
    assert tile & (tile - 1) == 0 and 128 <= tile < n_rays
    assert tile * dense <= budget < 2 * tile * dense


@pytest.mark.parametrize("limit,expected", [
    (None, "host"), (64 << 30, (64 << 30) // 104), (8 << 30, (8 << 30) // 104)])
def test_dense_pairs_follows_device_memory(monkeypatch, limit, expected):
    """A device that reports its memory limit gets a quarter of it at 26 B
    per pair; one that reports none (the host) gets HOST_DENSE_PAIRS."""
    from rtc_tpu.render import renderer

    class Dev:
        def memory_stats(self):
            return None if limit is None else {"bytes_limit": limit}

    monkeypatch.setattr(jax, "devices", lambda: [Dev()])
    if expected == "host":
        expected = renderer.HOST_DENSE_PAIRS
    assert renderer.dense_pairs() == expected


def test_default_config_lets_renderer_choose_tile():
    assert RenderConfig().ray_tile is None
