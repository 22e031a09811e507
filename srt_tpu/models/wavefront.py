"""One-bounce wavefront intersection API.

The reference keeps a dormant standalone intersect kernel reading a ray
SSBO and writing hit triangle ids (``ray_intersects.glsl:135-161``,
uploaded via ``UpdateRays``, gpu_loader.cpp:198-210) — the harness its
integration test drives (BVH_intergration_tests.cpp).  This module is that
capability as a first-class API: intersect an explicit ray batch against a
mesh scene and get global triangle indices (or -1), with optional full hit
data.  Useful for custom integrators, visibility queries, and as the
crafted-ray test surface.
"""

from __future__ import annotations

import jax.numpy as jnp

from srt_tpu.models.mesh import MeshScene, mesh_hit_fn


def intersect_rays(scene: MeshScene, origins, dirs, t_min: float = 1e-3,
                   t_max=None, method: str = "dense"):
    """Closest-hit sweep over explicit rays.

    origins/dirs: [N, 3].  Returns (tri_idx [N] int32 with -1 for miss,
    t [N] with inf for miss) — the wavefront-kernel contract
    (hits[index] = uint(-1) on miss, ray_intersects.glsl:145).  For the
    full shading record (position/normal/material) use ``intersect_full``.
    """
    idx, t = hit_ids(scene, origins, dirs, t_min=t_min, t_max=t_max,
                     method=method)
    return idx, jnp.where(idx >= 0, t, jnp.inf)


def intersect_full(scene: MeshScene, origins, dirs, t_min: float = 1e-3,
                   t_max=None, method: str = "dense"):
    """Closest-hit sweep returning the full ``Hit`` record (position,
    facing normal, converted material) — the shading-ready variant of
    ``intersect_rays``.  origins/dirs: [N, 3]."""
    n = origins.shape[0]
    if t_max is None:
        t_max = jnp.full((n,), jnp.inf)
    return mesh_hit_fn(scene, method=method)(
        jnp.asarray(origins, jnp.float32).T, jnp.asarray(dirs, jnp.float32).T,
        t_min, t_max, any_hit=False,
    )


def hit_ids(scene: MeshScene, origins, dirs, t_min: float = 1e-3,
            t_max=None, method: str = "dense"):
    """Just the per-ray hit triangle ids ([N] int32, -1 = miss), matching
    the reference integration test's readback (``GetHits``)."""
    from srt_tpu.models import mesh as mesh_mod

    n = origins.shape[0]
    o_t = jnp.asarray(origins, jnp.float32).T
    d_t = jnp.asarray(dirs, jnp.float32).T
    best_t = jnp.full((n,), jnp.inf) if t_max is None \
        else jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    best_i = jnp.full((n,), jnp.int32(-1))
    for b in range(scene.num_models):
        if method in mesh_mod.CANDIDATE_METHODS:
            t, i = mesh_mod.candidate_model_hit(scene, method)(
                scene, b, o_t, d_t, best_t)
        else:
            t, i, _, _ = mesh_mod._dense_model_hit(scene, b, o_t, d_t, best_t)
        better = (i != -1) & (t < best_t) & (t > t_min)
        best_t = jnp.where(better, t, best_t)
        best_i = jnp.where(better, i, best_i)
    return best_i, best_t
