#!/usr/bin/env python
"""Interactive-rate check: drive the user-facing RenderSession
(srt_tpu/app.py) with the fast path on the device JAX resolves and record
progressive frame rates at several resolutions — the analog of the
reference's 1000x800 interactive frame loop (src/main.cpp:600-769).
Each line names the device; all lines also go to
chiprun_out/interactive_session.jsonl.

Each scene/size runs warmup + timed accumulation frames, then a camera
move (accumulation reset, pose is a traced arg -> no recompile) + more
timed frames.  fps = 1000 / median frame ms.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from srt_tpu.app import RenderSession
from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.models import mesh as mesh_mod
from srt_tpu.scene import model_scene_lights
from srt_tpu.utils.flatten import flatten_models
from srt_tpu.utils.procgen import rubik_grid, uv_sphere


def run_case(name, scene, cam, cfg, frames=12):
    s = RenderSession(None, model_scene_lights(), cam, cfg,
                      scene=scene, fast=True)
    s.step()                                 # compile + warm
    # Device-resident frames: the reference's display texture never
    # leaves the GPU either, so the host fetch is timed separately.
    ms = []
    for _ in range(frames):
        t0 = time.perf_counter()
        s.step(fetch=False)
        ms.append((time.perf_counter() - t0) * 1e3)
    s.rotate(5.0, -2.0)                      # interaction: reset + retime
    s.move(forward=0.3)
    ms_moved = []
    for _ in range(frames):
        t0 = time.perf_counter()
        s.step(fetch=False)
        ms_moved.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    s.step(fetch=True)
    ms_fetch = (time.perf_counter() - t0) * 1e3
    med = statistics.median(ms)
    med2 = statistics.median(ms_moved)
    dev = jax.devices()[0]
    out = {
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "case": name, "width": cam.width, "height": cam.height,
        "median_frame_ms": round(med, 1), "fps": round(1000.0 / med, 1),
        "median_frame_ms_after_move": round(med2, 1),
        "fps_after_move": round(1000.0 / med2, 1),
        "frame_plus_host_fetch_ms": round(ms_fetch, 1),
        "frames_accumulated": s.frames_accumulated,
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    results = []
    hp = uv_sphere(160, 320, radius=2.0)     # the 102k-tri headline mesh
    hp_scene = mesh_mod.upload(flatten_models([hp]))
    cfg = RenderConfig(max_depth=4, rr_bounces=0)
    for size in (1024, 512, 256):
        cam = CameraConfig(width=size, height=size, origin=(0.0, 1.0, 5.0),
                           look_at=(0.0, 0.0, 0.0))
        results.append(run_case(f"headline-102k-{size}", hp_scene, cam,
                                cfg))

    rk_scene = mesh_mod.upload(flatten_models([rubik_grid()]))
    # The reference's interactive resolution is 1000x800 (main.cpp:600).
    cam = CameraConfig(width=1000, height=800, origin=(0.0, 20.0, 20.0),
                       look_at=(0.0, 1.0, -1.0))
    results.append(run_case("rubik-1000x800", rk_scene, cam, cfg))

    out_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "interactive_session.jsonl")
    with open(path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
