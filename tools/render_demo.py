#!/usr/bin/env python
"""Render the two flagship scenes to PNG — the one-command visual check.

Runs on whatever backend JAX resolves, with its traversal strategy
(``mesh.default_method``: the BVH kernel on a GPU, dense on the CPU).
Writes rubik.png (the reference's bundled asset when the mirror is
present) and highpoly.png (the ~102k-triangle Airplane stand-in,
BASELINE config 4) into --out (default chiprun_out/demo in the checkout).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chiprun_out", "demo"))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    import jax
    import numpy as np

    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.models import pathtracer
    from srt_tpu.ops import tonemap
    from srt_tpu.scene import model_scene_lights
    from srt_tpu.utils.flatten import flatten_models
    from srt_tpu.utils.procgen import rubik_grid, uv_sphere

    method = mesh_mod.default_method()
    lights = model_scene_lights()

    ref = "/root/reference/objects/Rubik/Rubik.obj"
    if os.path.exists(ref):
        from srt_tpu.utils.obj_loader import load_object
        rubik = load_object(ref)
    else:
        rubik = rubik_grid()

    scenes = [
        ("rubik", rubik, (0.0, 20.0, 20.0), (0.0, 1.0, -1.0)),
        ("highpoly", uv_sphere(160, 320, radius=2.0),
         (0.0, 1.0, 5.0), (0.0, 0.0, 0.0)),
    ]
    for name, mesh_data, origin, look_at in scenes:
        scene = mesh_mod.upload(flatten_models([mesh_data]))
        cam = CameraConfig(width=args.size, height=args.size,
                           origin=origin, look_at=look_at)
        cfg = RenderConfig(max_depth=4, rr_bounces=0, spp=args.spp)
        f = jax.jit(lambda k, s=scene: pathtracer.render(
            mesh_mod.mesh_hit_fn(s, method=method, ray_tile=4096),
            lights, cam, cfg, k))
        t0 = time.time()
        img = f(jax.random.key(0))
        jax.block_until_ready(img)
        srgb = np.asarray(tonemap.resolve(img, 1))
        path = os.path.join(args.out, f"{name}.png")
        try:
            from PIL import Image
            Image.fromarray((srgb * 255).astype(np.uint8)).save(path)
        except ImportError:
            from srt_tpu.utils.image import write_ppm
            path = path[:-4] + ".ppm"
            write_ppm(path, srgb)
        print(f"{name}: {mesh_data.num_triangles} tris, {time.time()-t0:.1f}s "
              f"({method}) -> {path}  srgb mean {srgb.mean():.3f}", flush=True)


if __name__ == "__main__":
    main()
