#!/usr/bin/env python
"""Multi-process multi-host exercise on the CPU (SURVEY.md section 2.3).

Launches 2 OS processes, each a JAX 'host' with 4 virtual CPU devices,
joined via ``jax.distributed.initialize`` on a localhost coordinator —
the CPU stand-in for a multi-host deployment (the same trick the tests
use for multiple devices, extended to multiple PROCESSES so the
``process_allgather`` assembly branch and the process-aware tile
assignment (``parallel/mesh.local_shard_bounds``) actually execute).
Every child pins itself to the CPU, so the tool never opens a GPU.

Each process renders only its own tile of a BVH-mesh scene
(``parallel/multihost.render_multihost``) and all-gathers the image; the
parent verifies every process assembled the SAME image and that it
matches a single-process render of the whole frame.  It checks
correctness only: CPU wall times say nothing about device scaling.

Usage:  python tools/multihost_2proc.py            # parent / driver
        python tools/multihost_2proc.py --proc I   # internal: child I
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = int(os.environ.get("SRT_MH_PORT", "19763"))
NPROC = 2
DEV_PER_PROC = 4
SIZE = (64, 32)          # W, H — small: CPU dense-mesh trace
SEED = 11
# Results pass between the processes through this directory.
OUT_DIR_ENV = "SRT_MH_DIR"


def _force_cpu(n_devices: int):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_devices}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def _scene_setup():
    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.scene import model_scene_lights
    from srt_tpu.utils.flatten import flatten_models
    from srt_tpu.utils.procgen import uv_sphere

    scene = mesh_mod.upload(flatten_models(
        [uv_sphere(12, 18)]))
    lights = model_scene_lights()
    cam = CameraConfig(width=SIZE[0], height=SIZE[1],
                       origin=(0.0, 1.0, 5.0), look_at=(0.0, 0.0, 0.0))
    cfg = RenderConfig(max_depth=2, rr_bounces=1, spp=1)
    return scene, lights, cam, cfg


def child(proc_id: int):
    jax = _force_cpu(DEV_PER_PROC)
    # Join the coordinator BEFORE importing srt_tpu: any import that
    # touches the backend would initialize it single-process and
    # jax.distributed.initialize would then fail.
    jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                               num_processes=NPROC, process_id=proc_id)
    from srt_tpu.parallel.mesh import device_mesh

    assert jax.process_count() == NPROC, \
        f"expected {NPROC} processes, got {jax.process_count()}"
    assert len(jax.devices()) == NPROC * DEV_PER_PROC

    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.parallel.multihost import render_multihost

    scene, lights, cam, cfg = _scene_setup()
    mesh = device_mesh()  # all 8 global devices on the rays axis

    def run(key):
        return render_multihost(
            lambda s: mesh_mod.mesh_hit_fn(s, method="dense"),
            scene, lights, cam, cfg, key, mesh)

    img = run(jax.random.key(SEED))

    import numpy as np
    out_dir = os.environ[OUT_DIR_ENV]
    out = {
        "proc": proc_id,
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "image_sum": float(np.asarray(img, np.float64).sum()),
        "image_sha": __import__("hashlib").sha256(
            np.ascontiguousarray(np.asarray(img)).tobytes()).hexdigest(),
    }
    with open(os.path.join(out_dir, f"proc{proc_id}.json"), "w") as f:
        json.dump(out, f)
    # Proc 0 also dumps the image for the parent's reference comparison.
    if proc_id == 0:
        np.save(os.path.join(out_dir, "img.npy"), np.asarray(img))
    print(f"proc {proc_id}: ok")


def parent():
    out_dir = tempfile.mkdtemp(prefix="srt_mh_")
    env = dict(os.environ, **{OUT_DIR_ENV: out_dir})
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          "--proc", str(i)], env=env)
        for i in range(NPROC)
    ]
    rcs = [p.wait(timeout=900) for p in procs]
    assert all(rc == 0 for rc in rcs), f"child exit codes: {rcs}"

    import numpy as np
    results = [json.load(open(os.path.join(out_dir, f"proc{i}.json")))
               for i in range(NPROC)]
    assert all(r["process_count"] == NPROC for r in results)
    # Every process must assemble the SAME full image.
    shas = {r["image_sha"] for r in results}
    assert len(shas) == 1, f"processes assembled different images: {shas}"

    # Single-process reference of the SAME render (8 local devices).
    jax = _force_cpu(NPROC * DEV_PER_PROC)
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.parallel.mesh import device_mesh
    from srt_tpu.parallel.multihost import render_multihost

    scene, lights, cam, cfg = _scene_setup()
    mesh = device_mesh()

    def run(key):
        return render_multihost(
            lambda s: mesh_mod.mesh_hit_fn(s, method="dense"),
            scene, lights, cam, cfg, key, mesh)

    ref = run(jax.random.key(SEED))
    img = np.load(os.path.join(out_dir, "img.npy"))
    max_diff = float(np.abs(np.asarray(ref) - img).max())
    bit_equal = bool((np.asarray(ref) == img).all())
    report = {
        "processes": NPROC,
        "devices_per_process": DEV_PER_PROC,
        "scene": "uv_sphere(12,18) BVH mesh, dense strategy",
        "image": f"{cam.width}x{cam.height}",
        "bit_equal_to_single_process": bit_equal,
        "max_abs_diff": max_diff,
        "assembled_identically_on_all_processes": True,
        "per_process": results,
    }
    print(json.dumps(report, indent=1))
    shutil.rmtree(out_dir)
    assert bit_equal or max_diff < 1e-6, \
        f"multi-process image diverged: {max_diff}"
    print("multihost_2proc: OK")


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--proc":
        child(int(sys.argv[2]))
    else:
        parent()
