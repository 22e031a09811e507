"""Wavefront tracing with alive-prefix compaction.

``trace_wavefront`` (models/pathtracer.py) runs the bounce loop as one
``lax.scan``: every bounce processes the full ``N``-ray wavefront even
though paths die fast (miss -> sky exit on bounce 1; RR later).  The
bounce re-sort already packs dead rays last, so a traversal that exits
dead rays early spends little on them — but the per-bounce XLA glue
(uniform gathers, BRDF shading, the sort itself) still runs at full
width.

Here the bounce loop is a **Python loop inside one jit** with a static
per-bounce **width schedule**: after each bounce's re-sort (live rays
first), the carry is sliced to the next scheduled width and the dropped
tail's radiance — final, because every dropped ray is dead — is
scatter-written once to a pixel-order accumulator.  Each ray exits the
wavefront exactly once, so the scatters total N rows across the frame.
XLA sees a straight-line program of shrinking shapes: no host
round-trips (no per-bounce alive-count pulls, no per-bounce full-width
scatter-ADDs), and the whole thing stays jittable and
reverse-differentiable (slice/scatter have exact transposes).

The bounce math is ``pathtracer.bounce_step`` — the SAME function the
scan integrator runs, so the two cannot drift: per-pixel output matches
to a few ulps (XLA fuses a scan body slightly differently than the same
body unrolled) and ray-count stats match exactly (tests/test_compact.py;
per-ray math never depends on batch width, and every pixel consumes its
own RNG slots via the position->pixel map).

The schedule comes from measurement, not guesses: ``discover_schedule``
runs one probe frame and converts its alive counts into granule-rounded
widths with a safety margin.  Path death is a property of (scene,
camera, depth) — not of the RNG key — so the schedule transfers across
frames; if a frame ever produces more live rays than its scheduled width
the trace reports ``overflow`` > 0 (checked by the caller) instead of
silently dropping paths: rays are never lost without detection.

Reference accounting analog: the megakernel's early-``return`` threads
(raytrace_compute.glsl:266-274) free SIMT lanes only until the
workgroup's slowest thread finishes; here freed rays shrink the whole
launch.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.models import pathtracer
from srt_tpu.ops.vec import bc
from srt_tpu.scene import Lights

# Width granule: schedule widths are multiples of this many rays.
GRANULE = 4096


def trace_compact(closest_hit, lights: Lights, origins, dirs, stream,
                  cfg: RenderConfig, schedule: Sequence[int],
                  pix_init=None, return_stats: bool = False,
                  emitters=None):
    """Jittable compacted wavefront trace.

    ``schedule``: static per-bounce widths, ``len == max_depth +
    rr_bounces``; ``schedule[0]`` must equal N (every primary ray is
    traced), later entries bound the live wavefront entering that bounce
    (see ``discover_schedule``).  Returns pixel-order radiance ``[3, N]``
    plus, with ``return_stats``, a ``[B, 2]`` int32 array of honest
    (traced, shadow) ray counts and an ``overflow`` scalar — the number
    of live rays that exceeded a scheduled width, summed over bounces.
    A nonzero overflow means the schedule under-provisioned and those
    rays were terminated mid-path: callers must treat the frame as
    invalid and re-derive the schedule (bench.py asserts 0).

    ``stream`` is consumed exactly like ``trace_wavefront``: one
    ``take(n_bounces * d_slots)`` block, slot-major, PIXEL order.
    ``pix_init`` maps wavefront position -> pixel id (identity when
    None); Morton-ordered callers pass the permutation so each ray
    consumes its own pixel's slots and radiance lands directly in pixel
    order — no unpermute pass.  ``pix_init`` MUST be a strict permutation
    of ``0..n-1``: the final assembly is argsort + packed row gather, so
    a duplicate pixel id would scramble rows rather than last-write like
    a scatter (spp-batched callers therefore pass unique SAMPLE ids,
    ``pixel*spp + s`` — see ``trace_image_compact``).
    """
    n = origins.shape[1]
    n_bounces = cfg.max_depth + cfg.rr_bounces
    schedule = tuple(int(w) for w in schedule)
    assert len(schedule) == n_bounces, \
        f"schedule has {len(schedule)} widths, need {n_bounces}"
    assert schedule[0] == n, "schedule[0] must cover every primary ray"
    assert all(a >= b for a, b in zip(schedule, schedule[1:])), \
        "schedule must be non-increasing (slices can only shrink)"
    nee_on = emitters is not None and cfg.nee
    from srt_tpu.ops.rng import bounce_slots
    d_slots = bounce_slots(lights.count, nee_on)
    # Uniform slots: gather-free per-bounce threefry evaluation at the
    # live sample ids (SlotBlock.rows_at; bit-identical to a
    # materialized take(), tested).
    u_blk = stream.take_block(n_bounces * d_slots)        # [B*D, N]

    # Exited rays accumulate as (pix, color) CHUNKS, assembled once at the
    # end by argsort + row gather instead of an arbitrary-row scatter per
    # bounce.  Every ray exits exactly once, so the chunks are a
    # permutation of the image.
    pix_chunks = []
    color_chunks = []
    carry = (
        origins,
        dirs,
        jnp.ones((3, n), jnp.float32),                    # throughput
        jnp.zeros((3, n), jnp.float32),                   # color (wavefront)
        jnp.ones((n,), bool),                             # alive
        (jnp.arange(n, dtype=jnp.int32) if pix_init is None
         else jnp.asarray(pix_init, jnp.int32)),          # pix
    )
    if cfg.ray_cones:
        carry = carry + (jnp.zeros((n,), jnp.float32),
                         jnp.full((n,), cfg.primary_spread, jnp.float32))
    if nee_on:
        # No-MIS sentinel for primary rays (pathtracer._NO_MIS_PDF).
        carry = carry + (jnp.full((n,), pathtracer._NO_MIS_PDF,
                                  jnp.float32),)
    overflow = jnp.int32(0)
    stats = []

    for b in range(n_bounces):
        width = schedule[b]
        if width < carry[0].shape[1]:
            # Slice to this bounce's width; the dropped tail is dead
            # (live-first sort) and its color is final — bank the chunk.
            pix_chunks.append(carry[5][width:])
            color_chunks.append(carry[3][:, width:])
            carry = tuple(
                x[:, :width] if x.ndim == 2 else x[:width] for x in carry)
        # Per-ray uniform slots via the position -> sample-id map.
        u = u_blk.rows_at(b * d_slots, (b + 1) * d_slots, carry[5])
        carry, st = pathtracer.bounce_step(
            closest_hit, lights, cfg, carry, b, u, sort=True,
            emitters=emitters)
        stats.append(st)
        if b + 1 < n_bounces:
            n_alive = jnp.sum(carry[4], dtype=jnp.int32)
            overflow = overflow + jnp.maximum(
                n_alive - schedule[b + 1], 0)

    # Paths that survive the static loop are truncated as a miss
    # (trace_wavefront parity), then the remaining slice exits.
    origins, dirs, throughput, color, alive, pix = carry[:6]
    color = color + jnp.where(bc(alive),
                              throughput * pathtracer._sky(dirs, cfg), 0.0)
    pix_chunks.append(pix)
    color_chunks.append(color)
    all_pix = jnp.concatenate(pix_chunks)
    all_color = jnp.concatenate(color_chunks, axis=1)
    # all_pix is a permutation of 0..n-1, so argsort IS its inverse; one
    # packed row gather lands radiance in pixel order (no scatter).
    image = all_color.T[jnp.argsort(all_pix)]

    if return_stats:
        return image.T, jnp.stack(stats), overflow
    return image.T


def trace_image_compact(closest_hit, lights: Lights, cam: CameraConfig,
                        cfg: RenderConfig, stream,
                        schedule: Sequence[int], origin=None, look_at=None,
                        return_stats: bool = False, emitters=None):
    """One full image via the compacted trace; linear [H, W, 3].
    Jittable with ``schedule`` static (see ``trace_compact``).

    ``cfg.spp > 1`` traces ALL samples in ONE wavefront, a pixel's K
    samples adjacent (sample-id order, id = pixel*K + s): an 8-ray kernel
    group then holds samples of ~one pixel — near-identical bounce
    origins, lobe-correlated directions — so its union traversal
    footprint approaches a single ray's instead of eight sorted pixels'
    (the r5 coherence lever; ROADMAP).  ``stream`` must carry
    ``n_rays == spp * W * H``; every (pixel, sample) consumes its own
    slot column, and ``schedule[0]`` must equal that total.  The returned
    image is the K-sample mean.  ``spp == 1`` is bit-identical to the r4
    behavior."""
    from srt_tpu.camera import derive_viewport, generate_rays
    if cfg.ray_cones and cfg.primary_spread == 0.0:
        import dataclasses
        cfg = dataclasses.replace(
            cfg, primary_spread=1.0 / (cam.focus_dist
                                       * min(cam.width, cam.height)))
    k = cfg.spp
    n_pix = cam.width * cam.height
    assert k * n_pix <= 2 ** 24, \
        "sample ids ride the packed f32 sort (pathtracer.bounce_step) " \
        "and must stay exact: spp * W * H <= 2^24"
    vp = derive_viewport(cam, origin=origin, look_at=look_at)
    jitter = stream.take(2)                                # [2, K*N]
    defocus = stream.take(2) if cam.defocus_angle > 0 else None
    origins, dirs = generate_rays(vp, cam.width, cam.height, jitter,
                                  defocus)
    pix_init = None
    if cfg.morton_order:
        from srt_tpu.ops.morton import morton_perm, permute_rays
        perm, _ = morton_perm(cam.height, cam.width)
        if k > 1:
            perm = (perm[:, None] * k
                    + np.arange(k, dtype=perm.dtype)[None, :]).reshape(-1)
        origins, dirs = permute_rays(origins, dirs, perm)
        # Uniforms stay in sample-id order; pix carries real sample ids,
        # so the in-step slot gather and the image assembly are both
        # direct — exactly the numbers PermutedStream would deliver.
        pix_init = perm
    out = trace_compact(closest_hit, lights, origins, dirs, stream, cfg,
                        schedule, pix_init=pix_init,
                        return_stats=return_stats, emitters=emitters)
    radiance = out[0] if return_stats else out
    if k > 1:
        # Sample-id rows -> per-pixel K-sample mean.
        radiance = jnp.mean(radiance.T.reshape(n_pix, k, 3), axis=1).T
    img = radiance.T.reshape(cam.height, cam.width, 3)
    if return_stats:
        return img, out[1], out[2]
    return img


def discover_schedule(closest_hit, lights: Lights, cam: CameraConfig,
                      cfg: RenderConfig, key, margin: float = 1.25,
                      min_width: int = GRANULE,
                      granule: int = GRANULE, emitters=None) -> tuple:
    """Measure one probe frame's per-bounce alive counts and round them
    into a width schedule with a safety ``margin``.

    Path death is driven by scene coverage and Russian roulette — both
    properties of the (scene, camera, depth) configuration, not of the
    RNG key — so a schedule from one frame transfers to others; the
    margin absorbs the per-key jitter and ``trace_compact``'s overflow
    output catches the residual.
    """
    from srt_tpu.ops.rng import KeyStream
    n = cam.width * cam.height * cfg.spp
    full = tuple([n] * (cfg.max_depth + cfg.rr_bounces))
    probe = jax.jit(lambda k: trace_image_compact(
        closest_hit, lights, cam, cfg, KeyStream(k, n), full,
        return_stats=True, emitters=emitters))
    _, stats, _ = probe(key)
    counts = np.asarray(stats)[:, 0]          # rays entering each bounce
    sched = [n]
    for b in range(1, len(counts)):
        # Exact granule-rounded widths (not a geometric ladder): every
        # width in the schedule compiles exactly once inside the single
        # jit, so there is nothing to amortize by coarsening.
        want = max(int(counts[b] * margin), min_width)
        sched.append(min(-(-want // granule) * granule, sched[-1], n))
    return tuple(sched)
