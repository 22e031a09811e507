"""Library-default fast render plan: the fastest measured full-frame
composition, packaged as public API.

``make_render_plan(scene, lights, cam, cfg)`` returns a compiled plan
whose ``render(key)`` drives the width-compacted wavefront driver
(models/wavefront_compact.py) with the platform's traversal strategy
(``mesh.default_method``) and the measured config toggles, so the number
the headline bench measures is what any user of the public API gets.

Small scenes (<= ``SMALL_SCENE_TRIS`` triangles) on a candidate-search
strategy run the ``lax.scan`` integrator instead: when traversal is cheap
the compacted driver's many small per-width fusions cost more than they
save.  The threshold is carried over from the first backend's
measurement and is to be re-measured on the GPU (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax

from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.scene import Lights

# Scenes up to this many (padded) triangles take the scan integrator.
SMALL_SCENE_TRIS = 16384


def plan_hit_fn(scene, method: str):
    """The plan's hit fn for ``method`` (dense sweeps in 8192-ray tiles to
    bound its [tile, T] working set)."""
    from srt_tpu.models import mesh as mesh_mod

    return mesh_mod.mesh_hit_fn(
        scene, method=method, ray_tile=8192 if method == "dense" else 0)


def use_scan_integrator(scene, method: str) -> bool:
    """Small scene on a candidate strategy: the scan integrator wins."""
    from srt_tpu.models import mesh as mesh_mod

    return (method in mesh_mod.CANDIDATE_METHODS
            and scene.tri_v0.shape[0] <= SMALL_SCENE_TRIS)


def plan_config(cfg: RenderConfig) -> RenderConfig:
    """The measured-default toggles: the all-specular shading shortcut
    (mesh material conversion sets use_spec for every triangle,
    raytrace_utils.glsl:173).  The bounce and late-shadow re-sorts stay as
    the caller set them; ``RenderConfig`` leaves them off, the faster
    choice for the kernel's headline frame on the H100 (PERF.md)."""
    return dataclasses.replace(cfg, uniform_use_spec=True)


@dataclasses.dataclass
class RenderPlan:
    """A compiled full-frame render plan.  ``render(key)`` returns
    ``(image [H, W, 3] linear, stats [B, 2] int32, overflow int32)``;
    callers must treat a frame with ``overflow != 0`` as invalid and
    rebuild the plan (the width schedule under-provisioned — see
    models/wavefront_compact.py)."""

    cam: CameraConfig
    cfg: RenderConfig
    schedule: tuple
    _fn: callable

    def render(self, key):
        return self._fn(key)


def make_render_plan(scene, lights: Lights, cam: CameraConfig,
                     cfg: Optional[RenderConfig] = None, key=None,
                     method: Optional[str] = None) -> RenderPlan:
    """Build the fastest known full-frame render plan for a mesh scene.

    Chooses the traversal method (``mesh.default_method`` unless given),
    enables the measured-default config toggles (``plan_config``), probes
    one frame to discover the compacted width schedule, and returns a
    jitted plan.

    The probe frame costs one extra compile + trace; the schedule
    transfers across frames and camera jitter (path death is a property
    of scene coverage, not the RNG key), and ``render`` reports overflow
    if it ever stops holding.
    """
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.models.wavefront_compact import (discover_schedule,
                                                  trace_image_compact)
    from srt_tpu.ops.rng import KeyStream

    if method is None:
        method = mesh_mod.default_method()
    cfg = plan_config(cfg or RenderConfig(max_depth=4, rr_bounces=0))
    n_bounces = cfg.max_depth + cfg.rr_bounces
    if key is None:
        key = jax.random.key(0)
    hit_fn = plan_hit_fn(scene, method)

    emitters = None
    if cfg.nee:
        from srt_tpu.models.emitters import scene_emitters
        emitters = scene_emitters(scene)

    n = cam.width * cam.height * cfg.spp
    if use_scan_integrator(scene, method) and cfg.spp == 1 \
            and emitters is None:
        # The scan body compiles once and reuses; the schedule is
        # trivially full-width.
        import jax.numpy as jnp

        from srt_tpu.models.pathtracer import trace_image_sample
        scfg = dataclasses.replace(cfg, sort_bounces=False)

        def scan_frame(k):
            img, stats = trace_image_sample(
                hit_fn, lights, cam, scfg, KeyStream(k, n),
                return_stats=True)
            return img, stats, jnp.int32(0)

        fn = jax.jit(scan_frame)
        schedule = (n,) * n_bounces
        return RenderPlan(cam=cam, cfg=scfg, schedule=schedule, _fn=fn)

    schedule = discover_schedule(hit_fn, lights, cam, cfg, key,
                                 emitters=emitters)
    fn = jax.jit(lambda k: trace_image_compact(
        hit_fn, lights, cam, cfg, KeyStream(k, n), schedule,
        return_stats=True, emitters=emitters))
    return RenderPlan(cam=cam, cfg=cfg, schedule=schedule, _fn=fn)
