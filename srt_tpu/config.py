"""Configuration dataclasses.

The reference has compile-time flags only (``src/main.cpp:133-139`` —
``RUN_COMPUTE_RT/RUN_RT/REND_TO_TEX/SHOW_MODEL``, ``WIDTH/HEIGHT``) plus
kernel-side hard-coded camera/sampling settings
(``shaders/raytrace_compute.glsl:366-384``).  Here everything is a runtime
dataclass; the static fields are hashable so configs can be passed as
``static_argnums`` to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera settings (reference ``CameraSettings``, camera.h:16-28).

    ``viewport_mode``:
      * ``"reference"`` — square 1x1 viewport at ``focus_dist`` regardless of
        aspect, exactly like ``GetCamera`` (raytrace_compute.glsl:47-76) where
        ``viewU = u*focusDist`` and ``viewV = v*focusDist`` (anisotropic
        pixels when width != height — a documented reference quirk).
      * ``"vfov"`` — viewport derived from ``vfov`` degrees and the true
        aspect ratio (square pixels; what the reference's vFov field was
        presumably meant to do).
    """

    width: int = 256
    height: int = 256
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    look_at: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    v_up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov: float = 90.0
    focus_dist: float = 1.0
    defocus_angle: float = 0.0
    viewport_mode: str = "reference"

    @property
    def aspect(self) -> float:
        return self.width / self.height


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Path-tracing settings.

    ``max_depth``/``rr_bounces``: the reference bounce loop
    (raytrace_compute.glsl:224-290) is ``while(true)`` with ``maxDepth`` free
    bounces then Russian roulette forever.  XLA needs static shapes, so we run
    ``max_depth + rr_bounces`` masked iterations; paths still alive after that
    are terminated as if they missed (throughput * sky added, see
    ``sky_always``).

    ``sky_always``: the reference adds ``throughput * sky`` at loop exit
    regardless of the exit reason (raytrace_compute.glsl:292) — even for
    RR-killed paths.  ``True`` reproduces that; ``False`` only credits sky to
    paths that exited on an actual miss (physically standard).

    ``flip_mesh_normals``: the reference uses the raw geometric triangle
    normal without facing it toward the ray (ray_intersects.glsl:90,
    raytrace_compute.glsl:157) so back-facing hits kill the path via
    ``dot(N, V) <= 0`` (brdf.glsl:242).  ``True`` (default) flips the normal
    to face the incoming ray, like the sphere path's ``SetFaceNormal``
    (raytrace_utils.glsl:23-26).
    """

    max_depth: int = 5
    rr_bounces: int = 3
    spp: int = 1
    t_min: float = 1e-3
    sky_color: Tuple[float, float, float] = (0.05, 0.05, 0.05)
    sky_gradient: bool = False
    sky_always: bool = True
    flip_mesh_normals: bool = True
    # All-specular shading shortcut: mesh material conversion
    # (TriangleToSupportedMat, raytrace_utils.glsl:173) sets useSpec=true
    # for EVERY triangle, making the diffuse direct-lighting variant dead
    # compute on mesh scenes.  True skips it (bit-identical image when
    # every material has use_spec; callers assert nothing — it is the
    # caller's promise).  Off by default for sphere-scene generality.
    uniform_use_spec: bool = False
    # Trace rays in Morton (Z-order) pixel order so kernel tiles cover
    # compact pixel blocks (the analog of the reference's 8x8 workgroups).
    # Bit-exact either way — the RNG stream is permuted with the rays
    # (ops/morton.py); False keeps plain row-major order.
    morton_order: bool = True
    # Re-sort the wavefront between bounces (dead-last, origin Morton
    # cell, direction octant) so kernel tiles stay coherent after the
    # primary bounce.  Bit-identical output (the RNG slots follow each
    # pixel); costs one u32 argsort + gathers per bounce; coherent rays
    # walk the BVH with less divergence.  Off by default: the dense/CPU
    # paths gain nothing (models/fastpath.SORT_DEFAULT per strategy).
    sort_bounces: bool = False
    # Re-sort each SHADOW batch by (dead-last, picked light, origin
    # Morton cell) before the any-hit trace, from this bounce index on
    # (None = off).  RIS picks lights per ray, so adjacent wavefront rays
    # aim at different lights and a per-group traversal walk pays the
    # union of segments toward up to six lights; grouping same-light
    # segments from nearby origins collapses that union (r5 measurement:
    # the late shadow passes were as expensive as their closest-hit
    # passes).  Bit-identical occlusion answers (the batch permutation is
    # inverted before shading).  Only honored where the bounce index is
    # static (the compacted driver); the lax.scan integrator ignores it.
    sort_shadows_from: Optional[int] = None
    # Next-event estimation toward emissive (Ke) triangles, combined
    # with BSDF sampling by the one-sample balance heuristic (r5; the
    # reference parses Ke but never lights with it).  Requires an
    # ``emitters`` table (models/emitters.py) passed to the trace; adds
    # 3 RNG slots per bounce and one extra shadow query per active hit.
    # Same expected image as hit-only emission, far lower variance on
    # small emitters (tests/test_nee.py).  Off by default: bit-exact
    # legacy behavior and oracle parity.
    nee: bool = False
    # Ray-cone footprint tracking for mip selection (the wavefront analog of
    # the GL driver's derivative-driven mipmapped samplers,
    # include/asset_utils/gpu_texture.h:39-53): each path carries a cone
    # (width, spread); width grows by t*spread per segment, spread widens
    # by the BRDF lobe at each bounce (cone_spec_spread * roughness for
    # specular, cone_diffuse_spread for diffuse).  Textured mesh scenes
    # then pick mip LODs from the actual footprint instead of the scalar
    # distance heuristic.  ``primary_spread`` is the per-unit-t pixel
    # footprint of camera rays; renderers derive it from the camera
    # (trace_image_sample) — 0 leaves camera rays footprint-free until
    # the first bounce.  Off by default (oracle parity).
    ray_cones: bool = False
    primary_spread: float = 0.0
    cone_diffuse_spread: float = 0.35
    cone_spec_spread: float = 0.25


# Reference defaults (src/main.cpp:137-138, raytrace_compute.glsl:366-384).
REFERENCE_WIDTH = 1000
REFERENCE_HEIGHT = 800

SPHERES_CAMERA = CameraConfig(
    width=REFERENCE_WIDTH,
    height=REFERENCE_HEIGHT,
    origin=(0.0, 0.0, 0.0),
    look_at=(0.0, 0.0, -1.0),
)

MODEL_CAMERA = CameraConfig(
    width=REFERENCE_WIDTH,
    height=REFERENCE_HEIGHT,
    origin=(0.0, 20.0, 20.0),
    look_at=(0.0, 1.0, -1.0),
)
