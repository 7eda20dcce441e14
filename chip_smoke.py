"""On-card smoke run: drives the renderer's main path once on the GPU.

    python chip_smoke.py          # one card: phases (a)-(h)
    python chip_smoke.py --four   # four cards: the sharded phase only

One process, one card (or four with --four). Phases:

  (a) device check: JAX must see GPUs; prints the card's name and power
      limit (nvidia-smi);
  (b) compile: both traversal kernels at 1920x960 on the cow and the herd,
      and the cow's render step, whose compiled memory analysis is printed;
  (c) kernel parity against brute force on the full primary and reflection
      wavefronts of cow, teapot_smooth, glass_teapot and cow_herd
      (bench.check_kernel_parity);
  (d) goldens: every registry scene with a tests/golden/<name>_w400.npy,
      rendered at 400x200 in f32 and held to tests/test_golden.py's
      per-scene budget at that width (F32_BUDGET_W400) of exact 8-bit
      matches and structural flips;
  (e) the cow at 1920x960 through rtc_tpu.cli.main (PPM written under
      chiprun_out/smoke/), then timed through bench.py's code;
  (f) cow_herd at 1920x960, once;
  (g) three train steps (diff.render_grad.make_train_step) on the cow at
      960x480; at 64x32 the kernel path's gradients must match brute force;
  (h) the tests marked `gpu`, run by pytest in this process.

Phases (e) and (f) run right after (b), so the peak-memory figure they
print is the render's, not the brute-force parity sweeps'. A failing phase
makes the script exit non-zero. On success the last line of stdout is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}. The
phase lines are also appended to chiprun_out/smoke/log.txt.
"""

import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

from bench import check

OUT_DIR = os.path.join("chiprun_out", "smoke")
FRAME = (1920, 960)


def _log(*args):
    print(*args, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "log.txt"), "a") as f:
        print(*args, file=f)


def _gpu_devices(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        raise SystemExit(f"chip_smoke.py needs {n} GPU(s); JAX found {devs}")
    return devs


def _scene(name, width, dtype=np.float32):
    from rtc_tpu.models.scenes import REGISTRY
    from rtc_tpu.scene.compile import compile_scene

    world, cam = REGISTRY[name](width)
    return compile_scene(world, dtype=dtype), cam


def phase_compile():
    import jax
    import jax.numpy as jnp

    import bench
    from rtc_tpu.ops.pallas import mesh_intersect as M
    from rtc_tpu.utils.config import RenderConfig

    for name in ("cow", "cow_herd"):
        scene, cam = _scene(name, FRAME[0])
        o, d = bench.primary_rays(cam, np.float32)
        tris = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb)
        kw = dict(leaf=scene.static.cluster_size)
        for label, fn in (
                ("closest_hit", lambda o, d: M.closest_hit(o, d, *tris, **kw)),
                ("any_hit", lambda o, d: M.any_hit(
                    o, d, jnp.full(o.shape[:1], 100.0), *tris, **kw))):
            t0 = time.perf_counter()
            jax.jit(fn).lower(o, d).compile()
            _log(f"(b) {name} {label} compiled for {o.shape[0]} rays in "
                 f"{time.perf_counter() - t0:.2f} s")
    scene, cam = _scene("cow", FRAME[0])
    _log(f"(b) cow render step memory: "
         f"{bench.step_memory(scene, cam, RenderConfig(dtype='float32'))}")


def phase_parity():
    import bench
    from rtc_tpu.utils.config import RenderConfig

    for name in ("cow", "teapot_smooth", "glass_teapot", "cow_herd"):
        scene, cam = _scene(name, FRAME[0])
        out = bench.check_kernel_parity(scene, cam,
                                        RenderConfig(dtype="float32"))
        _log(f"(c) {name} kernel parity: {out}")


def phase_goldens():
    import importlib.util

    from rtc_tpu.render.renderer import render
    from rtc_tpu.utils.config import RenderConfig

    spec = importlib.util.spec_from_file_location(
        "golden_specs", os.path.join("tests", "test_golden.py"))
    tg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tg)
    failed = []
    for name in sorted(tg.SPECS):
        path = os.path.join(tg.GOLDEN, f"{name}_w400.npy")
        if not os.path.exists(path):
            continue
        golden = np.load(path)
        _, depth = tg._spec(tg.SPECS[name])
        scene, cam = _scene(name, 400)
        img = np.asarray(render(scene, cam, RenderConfig(
            dtype="float32", max_depth=depth)))
        match = float(np.all(tg._quantize(golden) == tg._quantize(img),
                             axis=2).mean())
        flips = int((np.abs(golden - img).max(axis=2) > 0.15).sum())
        min_frac, budget = tg.F32_BUDGET_W400[name]
        ok = match >= min_frac and flips <= budget
        _log(f"(d) {name} 400x200 depth {depth}: exact-match {match:.4f} "
             f"(min {min_frac}), flips {flips} (budget {budget}), max err "
             f"{np.abs(golden - img).max():.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    check(not failed, f"golden budgets exceeded: {failed}")


def phase_cow_frame(card):
    import jax

    import bench
    from rtc_tpu import cli

    os.makedirs(OUT_DIR, exist_ok=True)
    ppm = os.path.join(OUT_DIR, "cow_1920.ppm")
    n = FRAME[0] * FRAME[1]
    rc = cli.main([ppm, str(FRAME[0]), "--report"])
    check(rc == 0 and os.path.getsize(ppm) > n, f"cli.main rc={rc}")
    with open(ppm) as f:
        header = [f.readline().strip(), f.readline().split()]
    check(header == ["P3", [str(FRAME[0]), str(FRAME[1])]],
          f"bad PPM header {header}")
    row = bench.bench_scene("cow", FRAME[0], frames=10, parity=False)
    _log(f"(e) cow {FRAME[0]}x{FRAME[1]} on {card}: frame "
         f"{row['frame_s_median'] * 1e3:.3f} ms median "
         f"(p90 {row['frame_s_p90'] * 1e3:.3f} ms, 10 frames), "
         f"{row['rays_per_s']:.6g} rays/s, compile {row['compile_s']:.2f} s, "
         f"peak_bytes_in_use {row['peak_bytes_in_use']}, impl "
         f"{row['mesh_impl']}, device {jax.devices()[0].device_kind}")


def phase_herd_frame(card):
    import jax

    from rtc_tpu.render.renderer import render
    from rtc_tpu.utils.config import RenderConfig

    scene, cam = _scene("cow_herd", FRAME[0])
    t0 = time.perf_counter()
    img = jax.block_until_ready(render(scene, cam,
                                       RenderConfig(dtype="float32")))
    wall = time.perf_counter() - t0
    img = np.asarray(img)
    check(img.shape == (FRAME[1], FRAME[0], 3) and np.isfinite(img).all(),
          f"herd frame {img.shape} not finite")
    check(img.max() > 0.1, "herd frame is black")
    _log(f"(f) cow_herd {FRAME[0]}x{FRAME[1]} ({scene.static.n_tris} "
         f"triangles) rendered once in {wall:.2f} s incl. compile on {card}")


def phase_train():
    import jax
    import jax.numpy as jnp
    import optax

    import bench
    from rtc_tpu.diff import render_grad as RG
    from rtc_tpu.render import integrator
    from rtc_tpu.utils.config import RenderConfig

    cfg = RenderConfig(dtype="float32")
    scene, cam = _scene("cow", 960)
    o, d = bench.primary_rays(cam, np.float32)
    target_scene = dataclasses.replace(
        scene, mat_color=scene.mat_color * jnp.asarray([0.6, 0.8, 0.9]))
    target = jax.jit(lambda s: integrator.color_at(s, o, d, cfg))(target_scene)
    params = RG.extract_params(scene)
    tx = optax.adam(0.02)
    opt_state = tx.init(params)
    step = RG.make_train_step(tx, cfg)
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, scene, o, d, target)
        losses.append(float(loss))
    _, grads = RG.loss_and_grad(params, scene, o, d, target, cfg)
    finite = all(bool(jnp.all(jnp.isfinite(g))) for g in grads.values())
    _log(f"(g) cow 960x480 train losses {losses}, grads finite {finite}")
    check(np.isfinite(losses).all() and finite and losses[-1] < losses[0],
          f"train step: losses {losses}, grads finite {finite}")

    scene, cam = _scene("cow", 64)
    o, d = bench.primary_rays(cam, np.float32)
    params = RG.extract_params(scene)
    target = jnp.full_like(o, 0.5)
    _, gk = RG.loss_and_grad(params, scene, o, d, target, cfg)
    _, gb = RG.loss_and_grad(params, scene, o, d, target,
                             dataclasses.replace(cfg, mesh_impl="bruteforce"))
    err = max(float(jnp.max(jnp.abs(gk[k] - gb[k])))
              / (float(jnp.max(jnp.abs(gb[k]))) or 1.0) for k in gk)
    _log(f"(g) 64x32 kernel-vs-bruteforce gradient max relative error {err:.3e}")
    check(err < 1e-4, f"kernel gradients differ from brute force: {err}")


def phase_gpu_tests():
    import pytest

    os.environ["RTC_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join("tests", "test_gpu.py")])
    check(rc == 0, f"gpu-marked tests: pytest exit code {rc}")


def phase_four(card, width=FRAME[0], interpret=False):
    import jax

    import __graft_entry__
    from rtc_tpu.parallel.mesh import make_mesh
    from rtc_tpu.parallel.shard import pad_tris, render_sharded
    from rtc_tpu.render.renderer import render
    from rtc_tpu.utils.config import RenderConfig

    devs = jax.devices()[:4]
    on_gpu = devs[0].platform == "gpu"
    t0 = time.perf_counter()

    def compare(label, img1, img4, max_frac):
        img1, img4 = np.asarray(img1), np.asarray(img4)
        err = np.abs(img1 - img4).max(axis=-1)
        n_diff = int((err > 1e-4).sum())
        peaks = [(dv.memory_stats() or {}).get("peak_bytes_in_use")
                 for dv in devs]
        _log(f"(four) {label}: max |4-card - 1-card| {err.max():.3e}, "
             f"pixels > 1e-4: {n_diff} of {err.size} (gate "
             f"{max_frac * err.size:.0f}), per-card peak bytes {peaks}, "
             f"{time.perf_counter() - t0:.1f} s into the phase")
        # every card did work: each one's high-water mark moved
        check(n_diff <= max_frac * err.size and (all(peaks) or not on_gpu),
              f"{label}: {n_diff} pixels differ, peaks {peaks}")

    cfg = RenderConfig(dtype="float32", mesh_impl="triton",
                       interpret=interpret)
    scene, cam = _scene("cow", width)
    one = render(scene, cam, cfg)
    four = render_sharded(scene, cam, cfg, mesh=make_mesh(4, 1, devices=devs))
    # the shards' programs round a few shading values differently (max
    # 4.2e-05 on the card); no pixel moves by more than 1e-4
    compare("cow rays-sharded (4, 1)", one, four, 0.0)

    scene, cam = _scene("cow_herd", width)
    scene = pad_tris(scene, 4)
    one = render(scene, cam, cfg)
    mesh = make_mesh(1, 4, devices=devs)
    text = jax.jit(lambda s: render_sharded(s, cam, cfg, mesh=mesh,
                                            shard_prims=True)).lower(
        scene).as_text()
    check(interpret or "__gpu$xla.gpu.triton" in text,
          "no Triton kernel under shard_map")
    four = render_sharded(scene, cam, cfg, mesh=mesh, shard_prims=True)
    # 110 silhouette pixels of 1,843,200 flip, as many as between render()
    # and render_sharded() on one card: the sharded path generates its
    # primary rays in another program, whose directions differ in the last
    # bits (PERF.md). The gate allows 1 pixel in 10,000.
    compare("cow_herd prims-sharded (1, 4)", one, four, 1e-4)

    # the sharded train step, certified against one card inside
    __graft_entry__.dryrun_multichip(4)
    _log(f"(four) sharded train step matches one card on {card}, "
         f"{time.perf_counter() - t0:.1f} s into the phase")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    devs = _gpu_devices(4 if four else 1)
    import bench

    card = bench.card_line()
    _log(f"card: {card}")
    _log(f"(a) devices: {devs[:4] if four else devs[:1]}")

    from rtc_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if four:
        phases = [("four", lambda: phase_four(card))]
    else:
        phases = [("b compile", phase_compile),
                  ("e cow frame", lambda: phase_cow_frame(card)),
                  ("f herd frame", lambda: phase_herd_frame(card)),
                  ("c parity", phase_parity), ("d goldens", phase_goldens),
                  ("g train", phase_train), ("h gpu tests", phase_gpu_tests)]
    failed = []
    for label, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            _log(f"phase {label}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:  # a phase's failure must not hide the others
            traceback.print_exc()
            _log(traceback.format_exc(limit=3))
            _log(f"phase {label}: FAILED")
            failed.append(label)
    if failed:
        _log(f"failed phases: {failed}")
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
