#!/usr/bin/env python
"""Time the traversal strategies on the GPU at the headline shape.

    python tools/traversal_timing.py [--methods cuda,bvh,dense] [--no-frames]

Scene: ``uv_sphere(160, 320)`` (101,760 triangles), 1024^2 rays.  Per
query — primary closest-hit, bounce-2 closest-hit (diffuse bounces from
the primary hits) and shadow any-hit (segments from the primary hits to
the six lights) — each strategy's jitted ``mesh_hit_fn`` is timed; then
whole 4-bounce frames through ``fastpath.make_render_plan``, for the
kernel with the bounce re-sort on and off.  A dense frame is skipped
(and said so) when one dense query already takes more than 6 s.

Prints one JSON line per measurement, with the card's name and power
limit, and writes them to ``chiprun_out/traversal_timing.jsonl``.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def med_time(fn, *args, reps=5):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def queries(scene):
    """The three headline queries: (name, origins, dirs, t_max, any_hit)."""
    import jax
    import jax.numpy as jnp

    from srt_tpu.camera import derive_viewport, generate_rays
    from srt_tpu.config import CameraConfig
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.scene import model_scene_lights

    side = 1024
    n = side * side
    k1, k2 = jax.random.split(jax.random.key(0))
    cam = CameraConfig(width=side, height=side, origin=(0.0, 1.0, 5.0),
                       look_at=(0.0, 0.0, 0.0))
    o, d = generate_rays(derive_viewport(cam), side, side,
                         jax.random.uniform(k1, (2, n)))
    prim = jax.jit(lambda o, d: mesh_mod.mesh_hit_fn(scene, "bvh")(
        o, d, 1e-3, jnp.inf))(o, d)
    # Cosine-weighted diffuse bounce around the shading normal; rays
    # whose primary missed are dead (t_max = 0), as in the integrator.
    nrm = prim.normal
    u = jax.random.uniform(k2, (2, n))
    r, phi = jnp.sqrt(u[0]), 2 * jnp.pi * u[1]
    a = jnp.where(jnp.abs(nrm[0:1]) > 0.9, jnp.array([[0.0], [1.0], [0.0]]),
                  jnp.array([[1.0], [0.0], [0.0]]))
    t1 = jnp.cross(a.T, nrm.T).T
    t1 = t1 / jnp.maximum(jnp.linalg.norm(t1, axis=0), 1e-12)
    t2 = jnp.cross(nrm.T, t1.T).T
    d2 = (r * jnp.cos(phi) * t1 + r * jnp.sin(phi) * t2
          + jnp.sqrt(1 - u[0]) * nrm)
    alive = jnp.where(prim.hit, jnp.inf, 0.0)
    lights = model_scene_lights().position
    seg = lights[jnp.arange(n) % lights.shape[0]].T - prim.p
    dist = jnp.linalg.norm(seg, axis=0)
    return [
        ("primary", o, d, jnp.full((n,), jnp.inf), False),
        ("bounce2", prim.p, d2, alive, False),
        ("shadow", prim.p, seg / dist[None, :], jnp.where(prim.hit, dist, 0.0),
         True),
    ]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--methods", default="cuda,bvh,dense")
    ap.add_argument("--no-frames", action="store_true")
    args = ap.parse_args()

    import jax

    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.models.fastpath import make_render_plan, plan_hit_fn
    from srt_tpu.scene import model_scene_lights
    from srt_tpu.utils.compile_cache import enable_compile_cache
    from srt_tpu.utils.flatten import flatten_models
    from srt_tpu.utils.procgen import uv_sphere

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    out = open(os.path.join(out_dir, "traversal_timing.jsonl"), "a")

    def emit(**rec):
        rec.update(card=card, device_kind=dev.device_kind,
                   platform=dev.platform, device_count=len(jax.devices()))
        line = json.dumps(rec)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    scene = mesh_mod.upload(flatten_models([uv_sphere(160, 320, radius=2.0)]))
    methods = args.methods.split(",")
    slow_dense = False
    for name, o, d, t_max, any_hit in queries(scene):
        for m in methods:
            if m == "dense" and slow_dense:
                emit(query=name, method=m, ms=None,
                     note="skipped: a dense query took > 6 s")
                continue
            hit = plan_hit_fn(scene, m)
            fn = jax.jit(lambda o, d, tm, hit=hit: hit(
                o, d, 1e-3, tm, any_hit=any_hit).hit)
            dt = med_time(fn, o, d, t_max, reps=5 if m == "cuda" else 2)
            emit(query=name, method=m, rays=int(o.shape[1]), ms=dt * 1e3)
            if m == "dense" and dt > 6.0:
                slow_dense = True
    if args.no_frames:
        return

    lights = model_scene_lights()
    cam = CameraConfig(width=1024, height=1024, origin=(0.0, 1.0, 5.0),
                       look_at=(0.0, 0.0, 0.0))
    cfg = RenderConfig(max_depth=4, rr_bounces=0)
    runs = [(m, s) for m in methods for s in ((False, True)
                                              if m == "cuda" else (False,))]
    for m, sort in runs:
        if m == "dense" and slow_dense:
            emit(frame="headline", method=m, ms=None,
                 note="skipped: a dense query took > 6 s, so a frame of "
                      "~8 queries takes longer than a minute")
            continue
        plan = make_render_plan(
            scene, lights, cam,
            dataclasses.replace(cfg, sort_bounces=sort,
                                sort_shadows_from=2 if sort else None),
            method=m)
        _, stats, _ = plan.render(jax.random.key(1))
        dt = med_time(plan.render, jax.random.key(2),
                      reps=5 if m == "cuda" else 2)
        rays = int(stats.sum())
        emit(frame="headline", method=m, sort=plan.cfg.sort_bounces,
             ms=dt * 1e3, rays=rays, mrays_per_s=rays / dt / 1e6)


if __name__ == "__main__":
    main()
