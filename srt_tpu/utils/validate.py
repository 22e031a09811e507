"""Render-state validation and self-healing.

Device-side analog of the reference's runtime guards: ``ValidateRenderState``
recreates the quad pipeline when GL handles go bad (src/main.cpp:358-379),
the GL debug callback surfaces driver errors (main.cpp:141-155,412-420),
and NaN pixels are painted green in-kernel (raytrace_compute.glsl:408-410).
XLA cannot lose "handles", so the failure modes that remain are numeric:
non-finite radiance leaking into the accumulation buffer (bad gradients
upstream, degenerate geometry, overflowing throughput) and a corrupted
camera basis after long interactive drift (camera.cpp:173-184
re-orthogonalizes periodically for the same reason).

``validate_render_state`` inspects a frame + accumulation state and
returns a report; ``heal`` applies the recovery the reference would:
quarantine non-finite accumulation texels (so one bad frame doesn't poison
progressive accumulation forever) and re-orthonormalize the camera.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class RenderStateReport:
    """One validation snapshot (all counts are per-call, host ints)."""

    nonfinite_frame: int      # non-finite texels in the incoming frame
    nonfinite_accum: int      # non-finite texels in the accumulation buffer
    negative_accum: int       # negative-radiance texels (sign corruption)
    camera_skew: float        # max |dot| between camera basis vectors
    ok: bool

    def __str__(self):
        state = "ok" if self.ok else "DEGRADED"
        return (f"render-state {state}: nonfinite frame={self.nonfinite_frame} "
                f"accum={self.nonfinite_accum} neg={self.negative_accum} "
                f"camera-skew={self.camera_skew:.2e}")


def camera_skew(forward, up, right) -> float:
    """Max pairwise |dot| of the camera basis (0 for a healthy basis)."""
    f, u, r = (np.asarray(v, np.float64) for v in (forward, up, right))

    def nrm(v):
        return v / max(np.linalg.norm(v), 1e-12)

    f, u, r = nrm(f), nrm(u), nrm(r)
    return float(max(abs(f @ u), abs(f @ r), abs(u @ r)))


def validate_render_state(frame, accum, camera=None,
                          skew_tol: float = 1e-3) -> RenderStateReport:
    """Inspect one frame + the accumulation buffer (host-side, cheap)."""
    frame = np.asarray(frame)
    accum = np.asarray(accum)
    nf_frame = int((~np.isfinite(frame)).sum())
    nf_accum = int((~np.isfinite(accum)).sum())
    neg = int((accum < 0.0).sum())
    skew = 0.0
    if camera is not None:
        front, right, up = camera.basis()
        skew = camera_skew(front, up, right)
    return RenderStateReport(
        nonfinite_frame=nf_frame,
        nonfinite_accum=nf_accum,
        negative_accum=neg,
        camera_skew=skew,
        ok=(nf_frame == 0 and nf_accum == 0 and neg == 0
            and skew <= skew_tol),
    )


def heal_accumulation(accum):
    """Quarantine corrupted accumulation texels: non-finite or negative
    entries are zeroed (they re-converge from subsequent frames) — the
    progressive-accumulation analog of the reference rebuilding its quad
    pipeline in place.  Returns (accum, healed_texel_count)."""
    bad = ~jnp.isfinite(accum) | (accum < 0.0)
    healed = jnp.where(bad, 0.0, accum)
    return healed, int(np.asarray(bad).sum())
