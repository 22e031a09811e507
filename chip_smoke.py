#!/usr/bin/env python
"""Smoke run of the path tracer's main path on one GPU, at full width.

    python chip_smoke.py            # phases 1-4 on one GPU
    python chip_smoke.py --four     # the sharded path on four GPUs only

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: JAX's first device must be a GPU (no CPU fallback); prints its
   kind and ``nvidia-smi``'s name and power limit.
2. kernel parity: the GPU traversal kernel against the plain-XLA "bvh"
   strategy at the headline scene (``uv_sphere(160, 320)``, 101,760
   triangles) on 1024^2 primary, random bounce-like and shadow-segment
   queries.
3. frames: headline frames through ``fastpath.make_render_plan``
   (1024^2, 4 bounces), one NEE frame on the emissive scene (512^2), and
   ``app.RenderSession(fast=True)`` frames at the reference's 1000x800,
   depth 5 + Russian roulette, with camera moves; images and ray counts
   against the "bvh" strategy with the same key.
4. inverse rendering: vertex + material gradients at 256^2 (material
   gradients against "bvh"), then two ``optim.run_inverse_rendering``
   steps that refit the traversal tables to the moved vertices.

``--four`` renders and takes one gradient step with the kernel inside
``shard_map`` over four GPUs and compares with the same program on one.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

HEADLINE = dict(rows=160, cols=320, radius=2.0)   # 101,760 triangles
CAM_ORIGIN = (0.0, 1.0, 5.0)
T0 = time.perf_counter()


def log(*args):
    print(f"{time.perf_counter() - T0:7.1f}s", *args, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def phase_device():
    import jax

    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"no GPU: JAX's first device is on {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    log(f"[device] {dev.device_kind} x{len(jax.devices())}")
    log(card)
    return card


def headline_scene():
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.utils.flatten import flatten_models
    from srt_tpu.utils.procgen import uv_sphere

    mesh = uv_sphere(HEADLINE["rows"], HEADLINE["cols"],
                     radius=HEADLINE["radius"])
    check(mesh.num_triangles == 101760, "headline scene size changed")
    return mesh_mod.upload(flatten_models([mesh]))


def parity_queries(scene, n_side=1024, seed=0):
    """(name, origins [3, N], dirs [3, N], t_min, t_max, any_hit) for the
    three query kinds at full width."""
    import jax
    import jax.numpy as jnp

    from srt_tpu.camera import derive_viewport, generate_rays
    from srt_tpu.config import CameraConfig
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.scene import model_scene_lights

    n = n_side * n_side
    k1, k2, k3, k4 = jax.random.split(jax.random.key(seed), 4)
    cam = CameraConfig(width=n_side, height=n_side, origin=CAM_ORIGIN,
                       look_at=(0.0, 0.0, 0.0))
    o_p, d_p = generate_rays(derive_viewport(cam), n_side, n_side,
                             jax.random.uniform(k1, (2, n)))
    # Bounce-like: origins inside the scene's box, directions uniform.
    o_b = jax.random.uniform(k2, (3, n), minval=-3.0, maxval=3.0)
    d_b = jax.random.normal(k3, (3, n))
    d_b = d_b / jnp.linalg.norm(d_b, axis=0, keepdims=True)
    # Shadow segments: from the primary hit points toward the six lights.
    prim = jax.jit(lambda o, d: mesh_mod.mesh_hit_fn(scene, method="bvh")(
        o, d, 1e-3, jnp.inf))(o_p, d_p)
    p = jnp.where(prim.hit[None, :], prim.p,
                  jax.random.uniform(k4, (3, n), minval=-3.0, maxval=3.0))
    lights = model_scene_lights().position                      # [L, 3]
    l_pos = lights[jnp.arange(n) % lights.shape[0]].T
    seg = l_pos - p
    dist = jnp.linalg.norm(seg, axis=0)
    return [
        ("primary", o_p, d_p, 1e-3, jnp.full((n,), jnp.inf), False),
        ("bounce", o_b, d_b, 1e-3, jnp.full((n,), jnp.inf), False),
        ("shadow", p, seg / dist[None, :], 1e-3, dist, True),
    ]


def phase_parity(scene):
    import jax
    import jax.numpy as jnp

    from srt_tpu.models import mesh as mesh_mod

    for name, o, d, t_min, t_max, any_hit in parity_queries(scene):
        n = o.shape[1]
        out = {}
        for method in ("cuda", "bvh"):
            model_hit = mesh_mod.candidate_model_hit(scene, method)
            fn = jax.jit(lambda o, d, tm, mh=model_hit: mh(
                scene, 0, o, d, tm, any_hit=any_hit, t_min=t_min))
            jax.block_until_ready(fn(o, d, t_max))
            (t, i), dt = timed(fn, o, d, t_max)
            out[method] = (np.asarray(t), np.asarray(i))
            log(f"[parity] {name:8s} {method:4s} {n} rays {dt * 1e3:.3f} ms")
        (tk, ik), (tb, ib) = out["cuda"], out["bvh"]
        if any_hit:
            # Occlusion answers; the walk's t is the closest, the
            # kernel's the first found, so only the hit/miss is compared.
            hk = (ik >= 0)
            hb = (ib >= 0) & (tb > t_min)
            agree = float((hk == hb).mean())
            log(f"[parity] {name}: same occlusion on {agree:.6%} of rays "
                f"({int(hk.sum())} occluded)")
            check(agree >= 0.9999, f"{name}: any-hit agreement {agree}")
            continue
        same = ik == ib
        frac = float(same.mean())
        both = same & (ik >= 0)
        rel = np.abs(tk[both] - tb[both]) / np.maximum(tb[both], 1e-30)
        diff = ~same
        tie = diff & (ik >= 0) & (ib >= 0)
        tie[tie] = np.abs(tk[tie] - tb[tie]) <= 1e-5 * tb[tie]
        log(f"[parity] {name}: same triangle on {frac:.6%} of rays "
            f"({int(both.sum())} hits), max |dt|/t {rel.max(initial=0):.3e}, "
            f"{int(diff.sum())} differ ({int(tie.sum())} exact-t ties)")
        check(frac >= 0.9999, f"{name}: triangle agreement {frac}")
        check(rel.max(initial=0.0) <= 1e-5, f"{name}: t disagreement")


def bvh_frame(plan, scene, lights, emitters=None):
    """The plan's frame with the "bvh" walk in place of the kernel: same
    config, key stream and paths.  Without NEE it runs the ``lax.scan``
    integrator, which traces the same paths as the compacted driver (ray
    counts exactly, images to float rounding; tests/test_compact.py) and
    compiles one bounce body instead of an unrolled frame."""
    import jax

    from srt_tpu.models.fastpath import plan_hit_fn
    from srt_tpu.models.pathtracer import trace_image_sample
    from srt_tpu.models.wavefront_compact import trace_image_compact
    from srt_tpu.ops.rng import KeyStream

    n = plan.cam.width * plan.cam.height * plan.cfg.spp
    hit = plan_hit_fn(scene, "bvh")
    if emitters is None and plan.cfg.spp == 1:
        return jax.jit(lambda k: trace_image_sample(
            hit, lights, plan.cam, plan.cfg, KeyStream(k, n),
            return_stats=True) + (0,))
    return jax.jit(lambda k: trace_image_compact(
        hit, lights, plan.cam, plan.cfg, KeyStream(k, n), plan.schedule,
        return_stats=True, emitters=emitters))


def compare_frames(name, img_k, st_k, img_b, st_b):
    img_k, img_b = np.asarray(img_k), np.asarray(img_b)
    st_k, st_b = np.asarray(st_k, np.int64), np.asarray(st_b, np.int64)
    check(np.isfinite(img_k).all(), f"{name}: non-finite image")
    px = float((np.abs(img_k - img_b).max(axis=-1) > 1e-3).mean())
    diff = np.abs(st_k - st_b)
    log(f"[frames] {name}: {px:.5%} pixels differ > 1e-3 from 'bvh'; "
        f"per-bounce ray counts {st_k.tolist()} vs {st_b.tolist()}")
    check(px <= 1e-3, f"{name}: {px} of pixels differ")
    check((diff <= 1e-3 * st_b).all(), f"{name}: per-bounce ray counts differ")


def phase_frames(scene, card):
    frames_headline(scene, card)
    frames_nee(card)
    frames_session(scene, card)


def frames_headline(scene, card):
    import jax

    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.models.fastpath import make_render_plan
    from srt_tpu.scene import model_scene_lights

    lights = model_scene_lights()
    cam = CameraConfig(width=1024, height=1024, origin=CAM_ORIGIN,
                       look_at=(0.0, 0.0, 0.0))
    cfg = RenderConfig(max_depth=4, rr_bounces=0)
    method = mesh_mod.default_method()
    check(method == "cuda", f"GPU strategy is {method!r}")
    plan = make_render_plan(scene, lights, cam, cfg)
    key = jax.random.key(1)
    t0 = time.perf_counter()
    frame = plan._fn.lower(key).compile()
    log(f"[frames] headline compile {time.perf_counter() - t0:.1f} s; "
        f"schedule {plan.schedule}")
    log(f"[frames] memory_analysis: {frame.memory_analysis()}")
    for i in range(3):
        (img, stats, ovf), dt = timed(frame, jax.random.key(10 + i))
        check(int(ovf) == 0, "headline frame overflowed its schedule")
        check(np.isfinite(np.asarray(img)).all(), "non-finite frame")
        rays = int(np.asarray(stats).sum())
        check(rays > 0, "no rays counted")
        log(f"[frames] headline 1024^2 frame {i}: {dt * 1e3:.2f} ms, "
            f"{rays} rays, {rays / dt / 1e6:.1f} Mrays/s ({card})")
    img_b, st_b, ovf_b = bvh_frame(plan, scene, lights)(jax.random.key(10))
    check(int(ovf_b) == 0, "bvh frame overflowed")
    img_k, st_k, _ = frame(jax.random.key(10))
    compare_frames("headline", img_k, st_k, img_b, st_b)


def frames_nee(card):
    """NEE on config11's emissive scene at its full size."""
    import jax
    import jax.numpy as jnp

    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.models.emitters import scene_emitters
    from srt_tpu.models.fastpath import make_render_plan
    from srt_tpu.scene import Lights
    from srt_tpu.utils import procgen
    from srt_tpu.utils.flatten import flatten_models
    from srt_tpu.utils.obj_loader import MaterialDef

    lamp = procgen.cube(size=0.3, center=(0.9, 1.8, 0.6),
                        material=MaterialDef(diffuse=(0.0, 0.0, 0.0),
                                             specular=(0.0, 0.0, 0.0),
                                             emissive=(40.0, 32.0, 24.0)))
    recv = procgen.cube(size=2.2, center=(0.0, -0.4, 0.0),
                        material=MaterialDef(diffuse=(0.7, 0.7, 0.7),
                                             specular=(0.2, 0.2, 0.2)))
    e_scene = mesh_mod.upload(flatten_models([recv, lamp]))
    dim = Lights(position=jnp.asarray([[0.0, 500.0, 0.0]], jnp.float32),
                 color=jnp.asarray([[1.0, 1.0, 1.0]], jnp.float32),
                 intensity=jnp.asarray([1e-6], jnp.float32))
    e_cam = CameraConfig(width=512, height=512, origin=(0.0, 3.0, 2.5),
                         look_at=(0.0, 0.6, 0.0))
    e_cfg = RenderConfig(max_depth=3, rr_bounces=0, nee=True)
    e_plan = make_render_plan(e_scene, dim, e_cam, e_cfg)
    e_plan.render(jax.random.key(3))
    (img_k, st_k, ovf), dt = timed(e_plan.render, jax.random.key(4))
    check(int(ovf) == 0, "NEE frame overflowed")
    log(f"[frames] NEE 512^2 frame: {dt * 1e3:.2f} ms ({card})")
    img_b, st_b, _ = bvh_frame(e_plan, e_scene, dim,
                               scene_emitters(e_scene))(jax.random.key(4))
    compare_frames("nee", img_k, st_k, img_b, st_b)


def frames_session(scene, card):
    """The interactive session at the reference's shape."""
    from srt_tpu.app import RenderSession
    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.scene import model_scene_lights

    lights = model_scene_lights()
    s_cam = CameraConfig(width=1000, height=800, origin=CAM_ORIGIN,
                         look_at=(0.0, 0.0, 0.0))
    sess = RenderSession(None, lights, s_cam, RenderConfig(), scene=scene,
                         fast=True)
    check(sess._fast, "session left the fast path")
    t0 = time.perf_counter()
    sess.step(fetch=False)
    log(f"[frames] session first frame (compile) "
        f"{time.perf_counter() - t0:.1f} s")
    ms = []
    for i in range(6):
        if i == 3:
            sess.rotate(5.0, -2.0)
            sess.move(forward=0.3)
        t0 = time.perf_counter()
        disp = sess.step(fetch=False)
        ms.append((time.perf_counter() - t0) * 1e3)
    check(np.isfinite(np.asarray(disp)).all(), "non-finite session frame")
    render = sess._render_fast if sess._fast else sess._render_one
    check(render._cache_size() == 1,
          "session recompiled after its first frame")
    log(f"[frames] session 1000x800 depth 5+RR frames (ms): "
        f"{[round(x, 2) for x in ms]} ({card})")


def phase_inverse(scene):
    import jax
    import jax.numpy as jnp

    from srt_tpu import optim
    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.models import pathtracer
    from srt_tpu.scene import model_scene_lights

    lights = model_scene_lights()
    cam = CameraConfig(width=256, height=256, origin=CAM_ORIGIN,
                       look_at=(0.0, 0.0, 0.0))
    cfg = RenderConfig(max_depth=2, rr_bounces=0)
    key = jax.random.key(5)

    def render_fn(method):
        def render(params, k):
            diffuse, positions = params
            s = mesh_mod.refit_accel(mesh_mod.with_positions(
                scene.replace(mat_diffuse=diffuse), positions))
            return pathtracer.render(mesh_mod.mesh_hit_fn(s, method=method),
                                     lights, cam, cfg, k)
        return render

    target = jax.jit(render_fn("cuda"))(
        (scene.mat_diffuse, scene.positions), key)
    noise = 0.01 * jax.random.normal(jax.random.key(6),
                                     scene.positions.shape)
    init = (scene.mat_diffuse * 0.7, scene.positions + noise)
    grads = {}
    for m in ("cuda", "bvh"):
        loss = lambda p, r=render_fn(m): jnp.mean((r(p, key) - target) ** 2)
        (g_mat, g_pos), dt = timed(jax.jit(jax.grad(loss)), init)
        g_mat, g_pos = np.asarray(g_mat), np.asarray(g_pos)
        check(np.isfinite(g_mat).all() and np.isfinite(g_pos).all(),
              f"{m}: non-finite gradients")
        check(np.abs(g_mat).max() > 0 and np.abs(g_pos).max() > 0,
              f"{m}: zero gradients")
        grads[m] = g_mat
        log(f"[inverse] {m} gradient at 256^2: {dt * 1e3:.1f} ms "
            f"(incl. compile); |g_mat| {np.abs(g_mat).max():.3e}, "
            f"|g_pos| {np.abs(g_pos).max():.3e}")
    check(np.allclose(grads["cuda"], grads["bvh"], rtol=1e-3,
                      atol=1e-3 * np.abs(grads["bvh"]).max()),
          f"material gradients differ: {grads['cuda']} vs {grads['bvh']}")
    res = optim.run_inverse_rendering(render_fn("cuda"), init, target, key,
                                      steps=2, fixed_noise=True,
                                      log_every=1)
    check(all(np.isfinite(res.losses)), "non-finite loss")
    moved = float(jnp.abs(res.params[1] - init[1]).max())
    check(moved > 0, "vertices did not move")
    log(f"[inverse] 2 steps: losses {res.losses}, max vertex move {moved:.3e}")


def phase_four(card):
    import jax
    import jax.numpy as jnp

    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.parallel.mesh import device_mesh
    from srt_tpu.parallel.render_sharded import (render_sharded,
                                                 sharded_loss_and_grad)
    from srt_tpu.scene import model_scene_lights

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    scene = headline_scene()
    lights = model_scene_lights()
    method = mesh_mod.default_method()
    make_hit = lambda s: mesh_mod.mesh_hit_fn(s, method=method)
    meshes = {4: device_mesh(4, 1, devices=devs),
              1: device_mesh(1, 1, devices=devs[:1])}
    cam = CameraConfig(width=1024, height=1024, origin=CAM_ORIGIN,
                       look_at=(0.0, 0.0, 0.0))
    cfg = RenderConfig(max_depth=4, rr_bounces=0)
    key = jax.random.key(7)
    imgs = {}
    for k, mesh in meshes.items():
        fn = jax.jit(lambda s, k_, mesh=mesh: render_sharded(
            make_hit, s, lights, cam, cfg, k_, mesh))
        jax.block_until_ready(fn(scene, key))
        imgs[k], dt = timed(fn, scene, key)
        log(f"[four] 1024^2 4-bounce render on {k} GPU(s): "
            f"{dt * 1e3:.2f} ms ({card})")
    a, b = np.asarray(imgs[4]), np.asarray(imgs[1])
    check(np.isfinite(a).all(), "non-finite sharded image")
    log(f"[four] image 4 vs 1 GPU: bit-identical {np.array_equal(a, b)}, "
        f"max |diff| {np.abs(a - b).max():.3e}")
    check(np.abs(a - b).max() <= 1e-5, "sharded image differs")

    g_cam = CameraConfig(width=256, height=256, origin=CAM_ORIGIN,
                         look_at=(0.0, 0.0, 0.0))
    g_cfg = RenderConfig(max_depth=2, rr_bounces=0)
    target = jnp.zeros((g_cam.height, g_cam.width, 3), jnp.float32)
    out = {}
    for k, mesh in meshes.items():
        step = jax.jit(sharded_loss_and_grad(make_hit, lights, g_cam, g_cfg,
                                             mesh))
        (loss, grads), dt = timed(step, scene, target, key)
        new_diffuse = scene.mat_diffuse - 0.1 * grads.mat_diffuse
        check(np.isfinite(np.asarray(new_diffuse)).all(), "bad step")
        out[k] = (float(loss), np.asarray(grads.mat_diffuse),
                  np.asarray(grads.tri_v0))
        log(f"[four] gradient step on {k} GPU(s): loss {float(loss):.6e}, "
            f"{dt * 1e3:.1f} ms incl. compile")
    (l4, m4, v4), (l1, m1, v1) = out[4], out[1]
    log(f"[four] grads 4 vs 1 GPU: material max rel diff "
        f"{np.abs(m4 - m1).max() / max(np.abs(m1).max(), 1e-30):.3e}, "
        f"vertex max rel diff "
        f"{np.abs(v4 - v1).max() / max(np.abs(v1).max(), 1e-30):.3e}")
    # The image is bit-identical; the loss and gradients are sums whose
    # order follows the shards (float32 reassociation, ~1e-5 relative).
    check(abs(l4 - l1) <= 1e-4 * max(abs(l1), 1e-30), "sharded loss differs")
    check(np.allclose(m4, m1, rtol=1e-4, atol=1e-6 * np.abs(m1).max()),
          "sharded material gradients differ")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded path")
    args = ap.parse_args(argv)

    import jax

    from srt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = phase_device()
    if args.four:
        phase_four(card)
    else:
        scene = headline_scene()
        phase_parity(scene)
        phase_frames(scene, card)
        phase_inverse(scene)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
