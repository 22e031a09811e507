"""Progressive interactive-style render session.

The device-side equivalent of the reference's app layer (src/main.cpp frame loop +
InputHandler): a ``RenderSession`` owns the accumulation state, re-renders
one 1-spp frame per ``step()`` (raytrace_compute.glsl:400-406 semantics),
exposes the same camera verbs as the reference's input handling (WASD
movement, mouse-style rotation, reset — input_handler.cpp:30-138), and
invalidates the accumulation buffer on any camera change exactly like the
``resetAccumBuffer`` protocol (src/main.cpp:622-647).

No window system: frames resolve to sRGB numpy images the caller can save
(utils/image.py) or display however it likes.  The render step is jitted
once; camera pose enters as traced arguments so movement does NOT trigger
recompilation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from srt_tpu.camera import FPSCamera
from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.models.pathtracer import HitFn, trace_image_sample
from srt_tpu.ops import tonemap
from srt_tpu.ops.rng import KeyStream


class RenderSession:
    """Progressive accumulation renderer with FPS camera controls."""

    def __init__(self, closest_hit: HitFn, lights, cam: CameraConfig,
                 cfg: Optional[RenderConfig] = None, seed: int = 0,
                 show_model: bool = False, validate_every: int = 0,
                 log_fn=None, scene=None, fast: bool = False):
        """``validate_every > 0`` runs the render-state validator every N
        frames and self-heals corrupted accumulation texels
        (utils/validate.py — the ``ValidateRenderState`` analog,
        src/main.cpp:358-379).  ``log_fn(metrics_dict)`` receives the
        structured per-frame metrics (frame index, wall ms, accumulation
        depth, healed texels) — the frame-time print of main.cpp:616-620
        grown into machine-readable telemetry.

        ``fast=True`` (requires ``scene``, a MeshScene): per-frame
        tracing goes through the library fast path — the platform's
        traversal strategy + width-compacted driver
        (models/fastpath.py) — instead of the uniform-strategy scan,
        with camera pose still a traced argument so movement never
        recompiles.  The compaction width schedule is probed at the
        initial pose with extra margin; a frame that overflows it (the
        camera moved somewhere with more live paths) is retraced at
        full width and the schedule is permanently widened — frames are
        never silently wrong (models/wavefront_compact.py overflow
        contract)."""
        self.cfg = dataclasses.replace(cfg or RenderConfig(), spp=1)
        self.cam_cfg = cam
        self.camera = FPSCamera(position=tuple(cam.origin))
        self._show_model = show_model
        self._key = jax.random.key(seed)
        self._accum = jnp.zeros((cam.height, cam.width, 3), jnp.float32)
        self.frames_accumulated = 0
        self._frame_index = 0
        self._validate_every = validate_every
        self._log_fn = log_fn
        self.metrics = {
            "frames": 0, "last_frame_ms": 0.0, "avg_frame_ms": 0.0,
            "healed_texels": 0, "last_report": None,
        }

        n = cam.height * cam.width
        self._fast = bool(fast)
        # Jitted with the frame count TRACED, so a new count never
        # recompiles the accumulate step.
        self._accum_fn = jax.jit(
            lambda accum, sample, count: tonemap.accumulate(
                accum, sample, count))

        if fast:
            assert scene is not None, "fast=True needs the MeshScene"
            from srt_tpu.models import mesh as mesh_mod
            from srt_tpu.models.fastpath import (plan_hit_fn, plan_config,
                                                 use_scan_integrator)
            from srt_tpu.models.wavefront_compact import (
                discover_schedule, trace_image_compact)
            method = mesh_mod.default_method()
            if use_scan_integrator(scene, method):
                # Small scenes: the scan integrator beats the compacted
                # driver (see models/fastpath.make_render_plan).
                closest_hit = mesh_mod.mesh_hit_fn(scene, method=method)
                fast = False
                self._fast = False
        if fast:
            fcfg = plan_config(self.cfg)
            hit_fn = plan_hit_fn(scene, method)
            self._fast_cfg = fcfg
            # Extra margin over the plan default: the schedule must
            # survive camera motion, not just RNG jitter.
            self._schedule = discover_schedule(
                hit_fn, lights, cam, fcfg, self._key, margin=1.6)

            def render_fast(key, origin, look_at, schedule):
                img, _, ovf = trace_image_compact(
                    hit_fn, lights, cam, fcfg, KeyStream(key, n),
                    schedule, origin=origin, look_at=look_at,
                    return_stats=True)
                return img, ovf

            import functools
            self._render_fast = jax.jit(
                functools.partial(render_fast),
                static_argnames=("schedule",))
        else:

            def render_one(key, origin, look_at):
                stream = KeyStream(key, n)
                return trace_image_sample(
                    closest_hit, lights, cam, self.cfg, stream,
                    origin=origin, look_at=look_at,
                )

            self._render_one = jax.jit(render_one)

    # -- camera verbs (InputHandler analog) --------------------------------

    def move(self, forward=0.0, strafe=0.0, vertical=0.0):
        """WASD/Space/Shift (input_handler.cpp:30-78); resets accumulation."""
        self.camera.move(forward, strafe, vertical)
        self.reset_accumulation()

    def rotate(self, yaw_offset: float, pitch_offset: float):
        """Mouse-drag look (input_handler.cpp:81-138); resets accumulation."""
        self.camera.rotate(yaw_offset, pitch_offset)
        self.reset_accumulation()

    def reset_camera(self):
        """'R' key (input_handler.cpp:62-66): per-scene default pose."""
        self.camera.reset(self._show_model)
        self.reset_accumulation()

    def reset_accumulation(self):
        """``resetAccumBuffer`` protocol (main.cpp:622-647)."""
        self._accum = jnp.zeros_like(self._accum)
        self.frames_accumulated = 0

    # -- frame loop --------------------------------------------------------

    def step(self, fetch: bool = True) -> np.ndarray:
        """Trace one 1-spp frame, accumulate, return the sRGB display image
        (uint8-ready float [H, W, 3]).

        ``fetch=False`` keeps the display on DEVICE (blocked until
        ready) and skips the host copy — the analog of the reference's
        on-GPU blit (the display texture never leaves the GPU,
        src/main.cpp:600-769).  Fetch explicitly (or call with
        fetch=True) only when the host actually needs pixels."""
        import time

        t0 = time.perf_counter()
        key = jax.random.fold_in(self._key, self._frame_index)
        self._frame_index += 1
        origin = jnp.asarray(self.camera.position, jnp.float32)
        look_at = jnp.asarray(self.camera.look_at(), jnp.float32)
        if self._fast:
            sample, ovf = self._render_fast(key, origin, look_at,
                                            self._schedule)
            if int(ovf) != 0:
                # The pose outgrew the probed width schedule: retrace
                # this frame at full width (always sufficient) and keep
                # the widened schedule — one recompile, never a wrong
                # frame.
                n = self.cam_cfg.height * self.cam_cfg.width
                n_b = (self._fast_cfg.max_depth
                       + self._fast_cfg.rr_bounces)
                self._schedule = (n * self._fast_cfg.spp,) * n_b
                sample, ovf = self._render_fast(key, origin, look_at,
                                                self._schedule)
                assert int(ovf) == 0
        else:
            sample = self._render_one(key, origin, look_at)
        self._accum, display = self._accum_fn(
            self._accum, sample, jnp.int32(self.frames_accumulated)
        )
        self.frames_accumulated += 1

        if self._validate_every and self._frame_index % self._validate_every == 0:
            from srt_tpu.utils.validate import (heal_accumulation,
                                                validate_render_state)
            report = validate_render_state(sample, self._accum, self.camera)
            self.metrics["last_report"] = report
            if not report.ok:
                self._accum, healed = heal_accumulation(self._accum)
                self.metrics["healed_texels"] += healed

        if fetch:
            display = np.asarray(display)
        else:
            display = jax.block_until_ready(display)
        dt_ms = (time.perf_counter() - t0) * 1e3
        m = self.metrics
        m["frames"] += 1
        m["last_frame_ms"] = dt_ms
        m["avg_frame_ms"] += (dt_ms - m["avg_frame_ms"]) / m["frames"]
        if self._log_fn is not None:
            self._log_fn({"frame": self._frame_index, "ms": dt_ms,
                          "accumulated": self.frames_accumulated,
                          "healed_texels": m["healed_texels"]})
        return display

    def run(self, frames: int, callback: Optional[Callable] = None) -> np.ndarray:
        """Accumulate ``frames`` frames; returns the final display image.
        ``callback(i, display)`` per frame (e.g. save a turntable)."""
        display = None
        for i in range(frames):
            display = self.step()
            if callback is not None:
                callback(i, display)
        return display

    def snapshot(self) -> np.ndarray:
        """Current resolved sRGB image without tracing a new frame."""
        return np.asarray(
            tonemap.resolve(self._accum, max(1, self.frames_accumulated))
        )
