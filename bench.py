"""Benchmark: render a registry scene at 1920x960 on the GPU and time it.

    python bench.py [width] [--scene=cow] [--frames=10] [--no-parity]
                    [--compare]

Prints ONE JSON line on stdout: rays/s (median frame), the frame-time
median and 90th percentile over --frames frames (each ending in
jax.block_until_ready), compile seconds, the process's peak device memory
and the compiled render step's own memory, the device as JAX reports it,
and the card's name and power limit from nvidia-smi. The ray tile is the
renderer's own choice (renderer.tile_rays), as a user's render gets it.
Progress and the parity report go to stderr.

--compare times the triangle-traversal kernel against the brute-force sweep
on the same scene (the kernel-vs-XLA decision recorded in PERF.md); on the
herd, brute force takes max(1, frames // 10) frames, since one frame runs
for seconds.

Ray accounting: per pixel, one closest-hit sweep + one shadow sweep per live
bounce-tree node (utils.profiling.rays_per_pixel; cow: reflective -> 2
nodes at budget 5 -> 4 sweeps per pixel).

A measurement needs the GPU: without one this script exits non-zero, and on
the GPU a kernel whose parity check cannot run is a failure, not a skip.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

def check(ok, message: str) -> None:
    """A gate that holds under `python -O` too (unlike assert)."""
    if not ok:
        raise AssertionError(message)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {info}")
    return info


def primary_rays(cam, dtype):
    import jax.numpy as jnp

    from rtc_tpu.render.camera import camera_rays

    return camera_rays(
        jnp.asarray(cam.transform_inverse, dtype), cam.hsize, cam.vsize,
        jnp.asarray(cam.half_width, dtype), jnp.asarray(cam.half_height, dtype),
        jnp.asarray(cam.pixel_size, dtype), dtype)


def _chunked(fn, chunk, *arrays):
    """Run a brute-force function over ray chunks of `chunk` rays."""
    n = arrays[0].shape[0]
    parts = [fn(*(a[i:i + chunk] for a in arrays)) for i in range(0, n, chunk)]
    return [np.concatenate([np.asarray(p[k]) for p in parts])
            for k in range(len(parts[0]))]


def check_kernel_parity(scene, cam, cfg) -> dict:
    """Kernel vs brute force on the scene's full primary wavefront and its
    mirror-reflection wavefront (origins just off the hit surfaces):

      * hit masks equal; |dt| <= 1e-3; winners differ only at ties;
      * occlusion from free-space points (half-way to each primary hit)
        differs on at most max(2, R / 2048) rays (silhouette knife edges).

    Raises AssertionError on a mismatch. Returns the measured numbers. On
    the GPU with the kernel active this never skips."""
    import jax
    import jax.numpy as jnp

    from rtc_tpu.render import integrator
    from rtc_tpu.render.renderer import tile_rays
    from rtc_tpu.utils.constants import BIG

    impl = integrator._resolve_mesh_impl(scene, cfg, cfg.jnp_dtype())
    if impl != "triton":
        check(jax.default_backend() != "gpu" or cfg.mesh_impl == "bruteforce",
              f"kernel parity cannot run: impl {impl}")
        return {"skipped": f"mesh impl {impl}"}
    cfg_bf = dataclasses.replace(cfg, mesh_impl="bruteforce")
    kern = jax.jit(lambda o, d: integrator.mesh_closest(scene, o, d, cfg))
    brute = jax.jit(lambda o, d: integrator.mesh_closest(scene, o, d, cfg_bf))
    o, d = primary_rays(cam, cfg.jnp_dtype())
    chunk = tile_rays(scene, cfg_bf, o.shape[0])
    t, i = kern(o, d)
    hit = t < BIG * 0.5
    n = scene.tri_n[i]
    refl = d - 2.0 * jnp.sum(d * n, axis=1, keepdims=True) * n
    far = jnp.asarray(1e12, o.dtype)
    o2 = jnp.where(hit[:, None], o + d * jnp.where(hit, t, 1.0)[:, None]
                   + n * cfg.epsilon, far)
    d2 = jnp.where(hit[:, None], refl, 0.5773502692)
    out = {"rays": int(o.shape[0]), "max_dt": 0.0, "tie_winners": 0}
    for oo, dd in ((o, d), (o2, d2)):
        t_k, i_k = map(np.asarray, kern(oo, dd))
        t_b, i_b = _chunked(brute, chunk, oo, dd)
        hit_k, hit_b = t_k < BIG * 0.5, t_b < BIG * 0.5
        check((hit_k == hit_b).all(),
              f"hit masks differ on {(hit_k != hit_b).sum()} rays")
        dt = np.abs(t_k - t_b)[hit_k]
        out["max_dt"] = max(out["max_dt"], float(dt.max()) if dt.size else 0.0)
        check(out["max_dt"] <= 1e-3, f"closest-hit t diverges: {out}")
        ties = hit_k & (i_k != i_b)
        check((np.abs(t_k - t_b)[ties] <= 1e-3).all(),
              "kernel picked a non-closest triangle")
        out["tie_winners"] += int(ties.sum())
    t_k = np.asarray(t)
    point = o + d * jnp.asarray(np.where(hit, t_k * 0.5, 1.0))[:, None]
    occ_k = np.asarray(jax.jit(lambda p, lv: integrator.is_shadowed(
        scene, p, cfg, live=lv))(point, hit))
    occ_b, = _chunked(jax.jit(lambda p, lv: (integrator.is_shadowed(
        scene, p, cfg_bf, live=lv),)), chunk, point, hit)
    out["occlusion_diffs"] = int((occ_k != occ_b).sum())
    check(out["occlusion_diffs"] <= max(2, o.shape[0] // 2048),
          f"occlusion parity: {out}")
    return out


def step_memory(scene, cam, cfg) -> dict:
    """The compiled render step's own device memory (memory_analysis of
    renderer._shade_rays for this frame): argument, output and temporary
    bytes, independent of whatever ran earlier in the process."""
    from rtc_tpu.render.renderer import _shade_rays

    o, d = primary_rays(cam, cfg.jnp_dtype())
    # render() shades with ray_order normalised to "scanline"
    cfg = dataclasses.replace(cfg, ray_order="scanline")
    m = _shade_rays.lower(scene, o, d, cfg).compile().memory_analysis()
    return {"argument_bytes": m.argument_size_in_bytes,
            "output_bytes": m.output_size_in_bytes,
            "temp_bytes": m.temp_size_in_bytes}


def time_frames(scene, cam, cfg, frames: int) -> dict:
    """Compile once, then time `frames` renders, each ending in
    jax.block_until_ready.

    peak_bytes_in_use is the device's high-water mark over the whole
    process: it describes this configuration only when it is the first
    one measured in the process. step_memory gives the render step's own
    bytes whatever ran before."""
    import jax

    from rtc_tpu.render.renderer import render

    t0 = time.perf_counter()
    jax.block_until_ready(render(scene, cam, cfg))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(render(scene, cam, cfg))
        times.append(time.perf_counter() - t0)
    stats = jax.devices()[0].memory_stats() or {}
    return {"compile_s": compile_s, "frame_s": times,
            "frame_s_median": float(np.median(times)),
            "frame_s_p90": float(np.percentile(times, 90)),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "step_memory": step_memory(scene, cam, cfg)}


def bench_scene(scene_name: str, width: int, mesh_impl: str = "auto",
                frames: int = 10, parity: bool = True) -> dict:
    """Compile + time one scene; returns the metric dict."""
    from rtc_tpu.models.scenes import REGISTRY
    from rtc_tpu.render import integrator
    from rtc_tpu.render.renderer import tile_rays
    from rtc_tpu.scene.compile import compile_scene
    from rtc_tpu.utils.config import RenderConfig
    from rtc_tpu.utils.profiling import rays_per_pixel

    world, cam = REGISTRY[scene_name](width)
    cfg = RenderConfig(dtype="float32", mesh_impl=mesh_impl)
    scene = compile_scene(world, dtype=cfg.jnp_dtype())
    n_pix = cam.hsize * cam.vsize
    row = {"scene": scene_name, "width": cam.hsize, "height": cam.vsize,
           "depth": cfg.max_depth, "dtype": cfg.dtype,
           "mesh_impl": integrator._resolve_mesh_impl(scene, cfg,
                                                      cfg.jnp_dtype()),
           "ray_tile": tile_rays(scene, cfg, n_pix)}
    if parity:
        row["parity"] = check_kernel_parity(scene, cam, cfg)
        print(f"parity {scene_name}: {row['parity']}", file=sys.stderr,
              flush=True)
    row.update(time_frames(scene, cam, cfg, frames))
    casts = n_pix * rays_per_pixel(cfg.max_depth, scene.static.any_reflective,
                                   scene.static.any_refractive)
    row["rays_per_s"] = casts / row["frame_s_median"]
    return row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = dict(a[2:].split("=", 1) for a in argv
                if a.startswith("--") and "=" in a)
    flags = {a for a in argv if a.startswith("--") and "=" not in a}
    args = [a for a in argv if not a.startswith("--")]
    width = int(args[0]) if args else 1920
    scene = opts.get("scene", "cow")
    frames = int(opts.get("frames", 10))

    from rtc_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    device = require_gpu()
    card = card_line()
    print(f"card: {card}", file=sys.stderr, flush=True)

    if "--compare" in flags:
        rows = {}
        for impl, n in (("triton", frames), ("bruteforce", frames)):
            if impl == "bruteforce" and scene.startswith("cow_herd"):
                n = max(1, frames // 10)
            rows[impl] = bench_scene(scene, width, impl, n,
                                     parity=impl == "triton"
                                     and "--no-parity" not in flags)
            print(json.dumps(rows[impl]), file=sys.stderr, flush=True)
        out = {"metric": f"frame time, {scene} {width}x{width // 2}",
               "kernel_s": rows["triton"]["frame_s_median"],
               "bruteforce_s": rows["bruteforce"]["frame_s_median"],
               "rows": rows, "card": card, "device": device}
    else:
        row = bench_scene(scene, width, frames=frames,
                          parity="--no-parity" not in flags)
        out = {"metric": f"rays/s ({scene} {row['width']}x{row['height']}, "
                         f"depth {row['depth']}, f32)",
               "value": row["rays_per_s"], "unit": "rays/s", **row,
               "card": card, "device": device}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
