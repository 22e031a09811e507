"""Camera: viewport derivation, batched ray generation, FPS-style controls.

Wavefront analog of the reference camera stack: the GLSL ``GetCamera`` /
``GetRay`` (shaders/raytrace_compute.glsl:47-90) and the host-side FPS camera
(src/raytracer/camera.cpp — yaw/pitch basis, WASD movement, pitch clamp,
reset poses).  Instead of one ray per shader invocation, ``generate_rays``
produces the whole ``[H*W, 3]`` wavefront batch in one traced op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import chex
import jax.numpy as jnp

from srt_tpu.config import CameraConfig


@chex.dataclass(frozen=True)
class Viewport:
    """Derived per-frame camera frame (reference ``Camera`` struct fields).

    Matches ``GetCamera`` (raytrace_compute.glsl:47-76): ``pixel00`` is the
    center of pixel (0, 0), ``delta_u``/``delta_v`` step one pixel in x/y.
    The reference's ``focusDist`` clobber bug (assignment-in-expression at
    :71) is deliberately not reproduced; with ``defocus_angle == 0`` it has
    no visible effect.
    """

    center: jnp.ndarray    # [3]
    pixel00: jnp.ndarray   # [3]
    delta_u: jnp.ndarray   # [3]
    delta_v: jnp.ndarray   # [3]
    defocus_u: jnp.ndarray  # [3]
    defocus_v: jnp.ndarray  # [3]


def _normalize(v: jnp.ndarray) -> jnp.ndarray:
    return v / jnp.linalg.norm(v)


def camera_basis(origin, look_at, v_up) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Right-handed (u, v, w) basis with w pointing *away* from the view.

    Same convention as the GLSL kernel: ``w = -direction``, ``u = right``,
    ``v = up`` (raytrace_compute.glsl:58-60), where right/up come from the
    host camera's cross products (camera.cpp:173-184).
    """
    origin = jnp.asarray(origin, jnp.float32)
    look_at = jnp.asarray(look_at, jnp.float32)
    v_up = jnp.asarray(v_up, jnp.float32)
    front = _normalize(look_at - origin)
    right = _normalize(jnp.cross(front, v_up))
    up = _normalize(jnp.cross(right, front))
    return right, up, -front


def derive_viewport(cfg: CameraConfig, origin=None, look_at=None) -> Viewport:
    """Build the Viewport from a CameraConfig (``GetCamera`` analog).

    ``origin``/``look_at`` may be traced arrays to make camera pose
    differentiable; they default to the static config values.
    """
    origin = jnp.asarray(cfg.origin if origin is None else origin, jnp.float32)
    look_at = jnp.asarray(cfg.look_at if look_at is None else look_at, jnp.float32)
    u, v, w = camera_basis(origin, look_at, cfg.v_up)

    if cfg.viewport_mode == "reference":
        # Square focusDist x focusDist viewport (raytrace_compute.glsl:62-63).
        view_u = u * cfg.focus_dist
        view_v = v * cfg.focus_dist
    elif cfg.viewport_mode == "vfov":
        h = math.tan(math.radians(cfg.vfov) / 2.0)
        view_h = 2.0 * h * cfg.focus_dist
        view_w = view_h * cfg.aspect
        view_u = u * view_w
        view_v = v * view_h
    else:
        raise ValueError(f"unknown viewport_mode: {cfg.viewport_mode}")

    delta_u = view_u / cfg.width
    delta_v = view_v / cfg.height
    lower_left = origin - cfg.focus_dist * w - view_u / 2.0 - view_v / 2.0
    pixel00 = lower_left + 0.5 * (delta_u + delta_v)

    defocus_radius = cfg.focus_dist * math.tan(math.radians(cfg.defocus_angle / 2.0))
    return Viewport(
        center=origin,
        pixel00=pixel00,
        delta_u=delta_u,
        delta_v=delta_v,
        defocus_u=u * defocus_radius,
        defocus_v=v * defocus_radius,
    )


def generate_rays(vp: Viewport, width: int, height: int, jitter: jnp.ndarray,
                  defocus: jnp.ndarray = None):
    """Primary rays for the full image as a wavefront batch.

    ``jitter``: [2, N] uniforms in [0, 1) — the pixel-area sample
    (``SampleSquare``, raytrace_utils.glsl:10-17, centered here to
    [-0.5, 0.5)).  ``defocus``: optional [2, N] uniforms for thin-lens
    depth of field — ray origins sample the defocus disk
    (``defocusDiskSample``, camera.cpp:36-39; dormant in the reference's
    GPU path, raytrace_compute.glsl:83).  Returns (origins [3, N],
    directions [3, N]) — component-first wavefront layout (ops/vec.py) —
    with N = height*width in row-major (y, x) order; directions are
    unnormalized like the reference (``GetRay``, raytrace_compute.glsl:85).
    """
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.float32),
        jnp.arange(width, dtype=jnp.float32),
        indexing="ij",
    )
    i = xs.reshape(-1)
    j = ys.reshape(-1)
    if jitter.shape[1] != i.shape[0]:
        # spp-batched wavefront: K consecutive samples per pixel
        # (sample-id order, id = pixel*K + s).  Tracing a pixel's samples
        # ADJACENT in one wavefront makes 8-ray kernel groups share one
        # pixel's bounce footprint instead of eight different pixels' —
        # the r5 coherence mode (models/wavefront_compact.py).
        k, rem = divmod(jitter.shape[1], i.shape[0])
        assert rem == 0, \
            f"jitter width {jitter.shape[1]} is not a multiple of " \
            f"the pixel count {i.shape[0]}"
        i = jnp.repeat(i, k)
        j = jnp.repeat(j, k)
    off = jitter - 0.5
    px = vp.pixel00[:, None] \
        + (i + off[0])[None, :] * vp.delta_u[:, None] \
        + (j + off[1])[None, :] * vp.delta_v[:, None]
    origins = jnp.broadcast_to(vp.center[:, None], px.shape)
    if defocus is not None:
        r = jnp.sqrt(defocus[0])
        theta = 2.0 * jnp.pi * defocus[1]
        origins = origins \
            + (r * jnp.cos(theta))[None, :] * vp.defocus_u[:, None] \
            + (r * jnp.sin(theta))[None, :] * vp.defocus_v[:, None]
    return origins, px - origins


# ---------------------------------------------------------------------------
# FPS-style camera state (host-side analog of Camera/InputHandler:
# src/raytracer/camera.cpp:138-212, src/input_handler.cpp:30-138).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FPSCamera:
    """Mutable yaw/pitch camera used by the interactive session (app.py).

    Semantics mirror the reference: yaw -90 looks down -z; pitch clamped to
    +/-89 degrees (camera.cpp:106-117); basis recomputed from a fixed world
    up to avoid drift (camera.cpp:173-184).
    """

    position: Tuple[float, float, float] = (0.0, 1.0, 4.0)
    yaw: float = -90.0
    pitch: float = 0.0

    def basis(self):
        cy, sy = math.cos(math.radians(self.yaw)), math.sin(math.radians(self.yaw))
        cp, sp = math.cos(math.radians(self.pitch)), math.sin(math.radians(self.pitch))
        front = (cy * cp, sp, sy * cp)
        n = math.sqrt(sum(c * c for c in front))
        front = tuple(c / n for c in front)
        right = (
            front[1] * 0.0 - front[2] * 1.0,
            front[2] * 0.0 - front[0] * 0.0,
            front[0] * 1.0 - front[1] * 0.0,
        )
        rn = math.sqrt(sum(c * c for c in right)) or 1.0
        right = tuple(c / rn for c in right)
        up = (
            right[1] * front[2] - right[2] * front[1],
            right[2] * front[0] - right[0] * front[2],
            right[0] * front[1] - right[1] * front[0],
        )
        return front, right, up

    def move(self, forward=0.0, strafe=0.0, vertical=0.0):
        """WASD/Space/Shift movement (input_handler.cpp:30-78)."""
        front, right, up = self.basis()
        self.position = tuple(
            p + forward * f + strafe * r + vertical * u
            for p, f, r, u in zip(self.position, front, right, up)
        )

    def rotate(self, yaw_offset: float, pitch_offset: float):
        """Mouse-drag rotation with pitch clamp (camera.cpp:106-117)."""
        self.yaw += yaw_offset
        self.pitch = max(-89.0, min(89.0, self.pitch + pitch_offset))

    def reset(self, show_model: bool = False):
        """Per-scene default pose (camera.cpp:187-212)."""
        self.position = (0.0, 9.0, 40.0) if show_model else (0.0, 1.0, 4.0)
        self.yaw, self.pitch = -90.0, 0.0

    def look_at(self) -> Tuple[float, float, float]:
        front, _, _ = self.basis()
        return tuple(p + f for p, f in zip(self.position, front))

    def config(self, base: CameraConfig) -> CameraConfig:
        return dataclasses.replace(
            base, origin=tuple(self.position), look_at=self.look_at()
        )
