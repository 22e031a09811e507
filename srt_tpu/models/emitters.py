"""Area-emitter tables + sampling for next-event estimation (NEE).

The reference parses ``Ke`` but never lights with it
(/root/reference/src/model_loader.cpp:240-273 stores it; no shader reads
it).  srt_tpu credits ``throughput * Ke`` when a path HITS an emissive
triangle (models/mesh.py hit record) — this module adds the matching
light-sampling strategy: sample a point on an emissive triangle
(power-proportional triangle pick, uniform-area point), cast a shadow
segment, and combine with BSDF sampling by the one-sample balance
heuristic (models/pathtracer.bounce_step, ``cfg.nee``).  Pure
variance reduction: the combined estimator has the same expectation as
hit-only emission (tests/test_nee.py checks both the mean and the
variance drop).

Build is split so gradients flow: ``emitter_indices`` inspects the
CONCRETE uploaded scene on host (static emitter set), while
``build_emitters`` is traceable — world positions/areas go through the
differentiable ``frames`` and ``mat_emissive`` arrays, so NEE-rendered
images stay differentiable w.r.t. pose and emission.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from srt_tpu.ops import vec


class Emitters(NamedTuple):
    """Static-size emitter tables (E emissive triangles, world space)."""

    v0: jnp.ndarray        # [E, 3]
    e1: jnp.ndarray        # [E, 3]
    e2: jnp.ndarray        # [E, 3]
    normal: jnp.ndarray    # [E, 3] unit geometric normal (two-sided use)
    area: jnp.ndarray      # [E] world-space triangle area
    le: jnp.ndarray        # [E, 3] emitted radiance (Ke)
    cdf: jnp.ndarray       # [E] power-pick CDF (last entry 1.0)
    pick: jnp.ndarray      # [E] pick probability (matches cdf)
    # Dense per-GLOBAL-triangle pick_prob/area (0 for non-emitters): the
    # hit-side MIS weight gathers this at the hit index.
    tri_pdfa: jnp.ndarray  # [T]


def emitter_indices(scene) -> Optional[np.ndarray]:
    """Global indices of emissive triangles of a CONCRETE MeshScene
    (host-side; the emitter SET is static trace metadata the way the
    model directory is).  None when the scene has no emitters."""
    ke = np.asarray(scene.mat_emissive)
    tri_mat = np.asarray(scene.tri_mat)
    # Padding triangles carry mat index 0 of all-zero rows; emissive
    # padding cannot occur (flatten pads with degenerate zero triangles).
    emissive_mat = (ke > 0.0).any(axis=1)
    valid = np.zeros(tri_mat.shape[0], bool)
    # Only REAL triangles (padding rows are degenerate zero triangles).
    for first, count in zip(scene.model_first_tri, scene.model_tri_count):
        valid[first:first + count] = True
    idx = np.where(emissive_mat[tri_mat] & valid)[0]
    if idx.size == 0:
        return None
    return idx.astype(np.int32)


def build_emitters(scene, emit_idx: np.ndarray) -> Emitters:
    """Traceable emitter-table build for a static index set (from
    ``emitter_indices``).  Differentiable w.r.t. ``scene.frames``,
    vertices, and ``mat_emissive``."""
    emit_idx = np.asarray(emit_idx)
    e = emit_idx.shape[0]
    # Static per-emitter model id from the model directory.
    model_of = np.zeros(e, np.int32)
    for b, (first, count) in enumerate(
            zip(scene.model_first_tri, scene.model_padded_tri_count)):
        model_of[(emit_idx >= first) & (emit_idx < first + count)] = b

    v0m = scene.tri_v0[emit_idx]                      # [E, 3] model space
    v1m = scene.tri_v1[emit_idx]
    v2m = scene.tri_v2[emit_idx]

    def to_world(pts_m, b):
        # frames are world->model: x_m = R x_w + t  =>  x_w = R^-1 (x_m - t)
        fr = scene.frames[b]
        r_inv = jnp.linalg.inv(fr[:3, :3])
        return jnp.dot(pts_m - fr[:3, 3][None, :], r_inv.T,
                       precision=jax.lax.Precision.HIGHEST)

    v0 = v1 = v2 = None
    for b in range(scene.num_models):
        sel = (model_of == b)[:, None]
        w0, w1, w2 = to_world(v0m, b), to_world(v1m, b), to_world(v2m, b)
        v0 = w0 if v0 is None else jnp.where(sel, w0, v0)
        v1 = w1 if v1 is None else jnp.where(sel, w1, v1)
        v2 = w2 if v2 is None else jnp.where(sel, w2, v2)

    e1 = v1 - v0
    e2 = v2 - v0
    cr = jnp.cross(e1, e2)
    cr_len = jnp.sqrt(jnp.maximum(jnp.sum(cr * cr, axis=1), 1e-20))
    area = 0.5 * cr_len
    normal = cr / cr_len[:, None]

    le = scene.mat_emissive[scene.tri_mat[emit_idx]]  # [E, 3]
    power = jnp.maximum(jnp.sum(le, axis=1), 1e-12) * area
    total = jnp.sum(power)
    pick = power / total
    cdf = jnp.cumsum(pick)

    tri_pdfa = jnp.zeros((scene.tri_v0.shape[0],), jnp.float32)
    tri_pdfa = tri_pdfa.at[jnp.asarray(emit_idx)].set(
        pick / jnp.maximum(area, 1e-12))
    return Emitters(v0=v0, e1=e1, e2=e2, normal=normal, area=area, le=le,
                    cdf=cdf, pick=pick, tri_pdfa=tri_pdfa)


def scene_emitters(scene) -> Optional[Emitters]:
    """Convenience: host inspection + traceable build in one call (for
    callers outside jit; inside jit, hoist ``emitter_indices``)."""
    idx = emitter_indices(scene)
    if idx is None:
        return None
    return build_emitters(scene, idx)


def sample_emitters(em: Emitters, u_pick, u1, u2):
    """One area sample per ray: power-proportional triangle pick (CDF
    inversion) + uniform point (sqrt warp).  u_*: [N] uniforms.

    Returns ``(x [3, N] world point, n [3, N] unit emitter normal,
    le [3, N], pdf_a [N] area-measure pdf = pick/area)``."""
    e = em.cdf.shape[0]
    pick = jnp.clip(jnp.searchsorted(em.cdf, u_pick, side="right"), 0, e - 1)
    v0 = em.v0[pick].T                                # [3, N]
    e1 = em.e1[pick].T
    e2 = em.e2[pick].T
    su = jnp.sqrt(jnp.maximum(u1, 0.0))
    b1 = 1.0 - su
    b2 = u2 * su
    x = v0 + vec.bc(b1) * e1 + vec.bc(b2) * e2
    n = em.normal[pick].T
    le = em.le[pick].T
    pdf_a = em.pick[pick] / jnp.maximum(em.area[pick], 1e-12)
    return x, n, le, pdf_a
