"""Multi-host rendering (SPMD across several hosts).

The multi-controller pattern: every host runs the same program,
`jax.distributed.initialize()` wires the hosts together, rays shard across
the GLOBAL ('rays', 'prims') mesh (the devices of every host), and each
host materializes only its addressable shard of the image. Host 0 assembles the full canvas for output.

Tested end-to-end by tests/test_multihost.py: two spawned CPU processes
(localhost coordinator) render a scene through this module and process 0's
assembled image must equal a single-process render; a cross-host gradient
psum train step runs the same way.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from ..render.camera import Camera
from ..scene.compile import Scene
from ..utils.config import DEFAULT_CONFIG, RenderConfig
from .mesh import make_mesh
from .shard import render_sharded


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize passthrough (env-driven when args omitted)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def render_multihost(scene: Scene, camera: Camera,
                     cfg: RenderConfig = DEFAULT_CONFIG,
                     shard_prims: bool = False) -> Optional[np.ndarray]:
    """Render across all processes' devices. Returns the assembled (V, H, 3)
    image on process 0, None elsewhere.

    The ray colors come back as a global jax.Array sharded over 'rays'
    (a host only holds its addressable shards); they are allgathered to every
    host FIRST, then un-permuted and reshaped host-side — indexing a
    non-addressable array eagerly is not legal in multi-controller JAX.
    """
    from .shard import sharded_colors

    mesh = make_mesh(devices=jax.devices())  # global mesh, all hosts
    colors, inv, n_rays = sharded_colors(
        scene, camera, cfg, mesh=mesh, shard_prims=shard_prims)
    from jax.experimental import multihost_utils

    local = np.asarray(multihost_utils.process_allgather(colors, tiled=True))
    if jax.process_index() != 0:
        return None
    if inv is not None:
        local = local[np.asarray(inv)]
    return local[:n_rays].reshape(camera.vsize, camera.hsize, 3)


def train_step_multihost(scene: Scene, camera: Camera,
                         cfg: RenderConfig = DEFAULT_CONFIG, lr: float = 1e-2):
    """One data-parallel differentiable render step across ALL hosts: each
    device differentiates its local MSE loss, gradients psum-reduce over the
    global 'rays' axis (within and across hosts). Returns
    (loss, grads) replicated on every process."""
    import dataclasses

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..diff import render_grad as RG
    from ..render import integrator
    from ..render.camera import camera_rays
    from .shard import _to_global, scene_pspecs

    mesh = make_mesh(devices=jax.devices())  # all devices on 'rays', prims=1
    n_shards = mesh.shape["rays"]
    dtype = cfg.jnp_dtype()
    o, d = camera_rays(
        jnp.asarray(camera.transform_inverse, dtype),
        camera.hsize, camera.vsize,
        jnp.asarray(camera.half_width, dtype),
        jnp.asarray(camera.half_height, dtype),
        jnp.asarray(camera.pixel_size, dtype), dtype)
    pad = (-o.shape[0]) % n_shards
    o = jnp.pad(o, ((0, pad), (0, 0)))
    d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    target = jnp.full_like(o, 0.5)
    params = RG.extract_params(scene)
    n_total = o.shape[0] * 3
    inner_cfg = dataclasses.replace(cfg, ray_tile=max(1, o.shape[0] // n_shards))

    if jax.process_count() > 1:
        pspecs = scene_pspecs(scene, False)
        # tree_map per field: absent fields (None) globalize leaf-by-leaf
        # under the field's prefix spec
        scene = dataclasses.replace(scene, **{
            f.name: jax.tree_util.tree_map(
                lambda x, _s=getattr(pspecs, f.name): _to_global(mesh, _s, x),
                getattr(scene, f.name))
            for f in dataclasses.fields(Scene) if f.name != "static"
        })
        o, d, target = (_to_global(mesh, P("rays"), x)
                        for x in (o, d, target))
        params = jax.tree_util.tree_map(
            lambda x: _to_global(mesh, P(), x), params)

    ray_axes = "rays"

    def shard_fn(params_l, scene_l, o_l, d_l, t_l):
        def local_loss(p):
            scene_p = RG.inject_params(scene_l, p)
            img = integrator.color_at(scene_p, o_l, d_l, inner_cfg)
            return jnp.sum((img - t_l) ** 2)

        lval, grads = jax.value_and_grad(local_loss)(params_l)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, ray_axes) / n_total, grads)
        loss = jax.lax.psum(lval, ray_axes) / n_total
        return loss, grads

    pspec = jax.tree_util.tree_map(lambda _: P(), params)
    step = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(pspec, scene_pspecs(scene, False),
                  P("rays"), P("rays"), P("rays")),
        out_specs=(P(), pspec),
        check_vma=False,
    ))
    loss, grads = step(params, scene, o, d, target)

    def _local(x):
        # outputs are replicated (out_specs P()); every process reads its
        # addressable copy — no further collective needed
        return np.asarray(x.addressable_data(0)) if hasattr(
            x, "addressable_data") else np.asarray(x)

    return float(_local(loss)), jax.tree_util.tree_map(_local, grads)
