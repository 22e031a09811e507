"""Shadow-boundary gradients for MESH occluders.

The mesh analog of ``edge_aware.soft_shadow_fn`` (spheres): the binary
occlusion test (``CheckLightOccluded``,
/root/reference/shaders/raytrace_compute.glsl:167-176) gives occluder
geometry seen ONLY through its shadow exactly zero path-space gradient.
This module replaces it with a coverage ramp in the shadow segment's
signed distance to the occluder's SILHOUETTE:

* ``sdist`` = min over silhouette edges (w.r.t. the shadow direction:
  adjacent faces disagree in facing sign, or boundary) of the
  ray-line-to-edge-segment distance, restricted to closest approaches
  inside the clipped segment — the same edge machinery as
  ``edge_aware_mesh.silhouette_sdf_global``;
* ``pen``   = +sdist when the segment is occluded (binary any-hit),
  -sdist when lit: occlusion flips exactly when the segment crosses the
  occluder silhouette, so ``pen`` is CONTINUOUS through zero across the
  boundary and smooth in the vertex buffer on either side;
* ``mult``  = clip(0.5 - pen / band, 0, 1): deep shadow -> 0
  (hard-shadow parity), fully lit -> 1, a ``band``-wide world-space
  ramp whose gradient is the shadow-boundary term (FD-checked,
  tests/test_mesh_shadow_boundary.py).  As ``band -> 0`` it converges
  to the binary test.

(A first attempt drove the ramp with triangle-PLANE crossing
penetrations — max of barycentric edge distances.  Exact for
transversal crossings, but shadow segments GRAZING curved geometry
cross many planes near-tangentially and the crossing parameter is
ill-conditioned there: the max jumped as crossings popped in and out of
the segment window, and FD never converged on a 13k-triangle sphere.
Distance-to-silhouette-edge is stable because it never involves a
near-parallel plane solve.)

Cost: dense O(rays x edges) per model, like the sphere module's
O(rays x spheres) — an inverse-rendering tool, not the forward-bench
path (``ray_tile`` bounds the working set).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from srt_tpu.models.mesh import MeshScene, transform_rays
from srt_tpu.ops import vec
from srt_tpu.ops.vec import bc

HIGHEST = jax.lax.Precision.HIGHEST

BIG = 3.0e37


def model_edges(scene: MeshScene, b: int):
    """Deduplicated edge table of model ``b`` (owner = lower triangle
    id): numpy int arrays (e_i0, e_i1 [E] vertex ids; e_ta, e_tb [E]
    adjacent triangle ids, e_tb = -1 on boundaries).  Static per scene
    topology (tri_adj/tri_vidx are never traced)."""
    import numpy as _np

    adj_np = _np.asarray(scene.tri_adj)
    vidx_np = _np.asarray(scene.tri_vidx)
    lo = scene.model_first_tri[b]
    hi = lo + scene.model_tri_count[b]
    e_i0, e_i1, e_ta, e_tb = [], [], [], []
    for k in range(3):
        t_ids = _np.arange(lo, hi)
        nbr = adj_np[lo:hi, k]
        own = (nbr < 0) | (nbr > t_ids)
        t_own = t_ids[own]
        e_i0.append(vidx_np[t_own, k])
        e_i1.append(vidx_np[t_own, (k + 1) % 3])
        e_ta.append(t_own)
        e_tb.append(nbr[own])
    cat = _np.concatenate
    return cat(e_i0), cat(e_i1), cat(e_ta), cat(e_tb)


def _edge_normals(scene: MeshScene, e_ta, e_tb):
    """Unnormalized face normals [E, 3] of both triangles adjacent to
    each edge (tb < 0 reuses ta; the boundary test ignores it)."""
    pos = scene.positions

    def nrm(t):
        vidx = scene.tri_vidx[t]
        a = pos[vidx[:, 0]]
        b = pos[vidx[:, 1]]
        c = pos[vidx[:, 2]]
        return jnp.cross(b - a, c - a)

    return nrm(jnp.asarray(e_ta)), nrm(jnp.asarray(jnp.maximum(e_tb, 0)))


def _silhouette_edge_dist(scene: MeshScene, b: int, o_m, dn, t_lo, t_hi,
                          edges):
    """Min distance from ray lines (o_m, unit dn) to model ``b``'s
    silhouette-edge SEGMENTS whose closest approach lies in
    (t_lo, t_hi) [N].  Differentiable w.r.t. scene.positions."""
    e_i0, e_i1, e_ta, e_tb = edges
    pos = scene.positions
    p0 = pos[jnp.asarray(e_i0)]                   # [E, 3]
    p1 = pos[jnp.asarray(e_i1)]
    n_a, n_b = _edge_normals(scene, e_ta, e_tb)

    d_t = dn.T                                    # [N, 3]
    o_t = o_m.T
    f_a = jnp.dot(d_t, n_a.T, precision=HIGHEST)  # [N, E]
    f_b = jnp.dot(d_t, n_b.T, precision=HIGHEST)
    sil = (jnp.asarray(e_tb)[None, :] < 0) | (f_a * f_b <= 0.0)

    e_vec = p1 - p0
    w = p0[None, :, :] - o_t[:, None, :]          # [N, E, 3]
    a_v = jnp.cross(w, d_t[:, None, :])
    b_v = jnp.cross(e_vec[None, :, :], d_t[:, None, :])
    bb = jnp.sum(b_v * b_v, axis=2)
    s = jnp.clip(-jnp.sum(a_v * b_v, axis=2)
                 / jnp.where(bb > 1e-20, bb, 1.0), 0.0, 1.0)
    s = jnp.where(bb > 1e-20, s, 0.0)
    dvec = a_v + s[..., None] * b_v
    dist = jnp.sqrt(jnp.maximum(jnp.sum(dvec * dvec, axis=2), 1e-30))
    t_c = jnp.sum((w + s[..., None] * e_vec[None, :, :])
                  * d_t[:, None, :], axis=2)
    near = (t_c > t_lo[:, None]) & (t_c < t_hi[:, None])
    return jnp.min(jnp.where(sil & near, dist, BIG), axis=1)


def mesh_soft_shadow_fn(scene: MeshScene, band: float,
                        ray_tile: int = 0):
    """Build a ``shadow_fn`` for ``pathtracer.bounce_step``: continuous
    light visibility with silhouette-distance ramps (see module
    docstring).  ``band`` is the ramp width in world units; ``ray_tile``
    > 0 processes shadow rays in ``lax.map`` tiles to bound the [N, E]
    working set."""
    edges = [model_edges(scene, b) for b in range(scene.num_models)]

    def sdist_all(p, dn, t_min, dist):
        out = jnp.full(p.shape[1:2], BIG)
        for b in range(scene.num_models):
            o_m, d_m = transform_rays(scene.frames[b], p, dn)
            out = jnp.minimum(out, _silhouette_edge_dist(
                scene, b, o_m, d_m, jnp.full_like(dist, t_min), dist,
                edges[b]))
        return out

    def fn(closest_hit, p, l_pos, t_min, active):
        delta = l_pos - p
        dist2 = vec.norm2(delta)
        dist = jnp.sqrt(jnp.where(dist2 > 0.0, dist2, 1.0))
        dn = delta / bc(jnp.maximum(dist, 1e-8))
        occ = closest_hit(p, dn, t_min, dist, any_hit=True).hit

        if ray_tile and p.shape[1] > ray_tile:
            n = p.shape[1]
            pad = (-n) % ray_tile
            p_p = jnp.pad(p, ((0, 0), (0, pad)))
            d_p = jnp.pad(dn, ((0, 0), (0, pad)), constant_values=1.0)
            dist_p = jnp.pad(dist, (0, pad))
            tiles = (n + pad) // ray_tile
            sdist = jax.lax.map(
                lambda args: sdist_all(args[0], args[1], t_min, args[2]),
                (p_p.reshape(3, tiles, ray_tile).transpose(1, 0, 2),
                 d_p.reshape(3, tiles, ray_tile).transpose(1, 0, 2),
                 dist_p.reshape(tiles, ray_tile)),
            ).reshape(-1)[:n]
        else:
            sdist = sdist_all(p, dn, t_min, dist)

        pen = jnp.where(occ, sdist, -sdist)
        mult = jnp.clip(0.5 - pen / jnp.maximum(band, 1e-6), 0.0, 1.0)
        if active is not None:
            mult = jnp.where(active, mult, 1.0)
        return mult

    return fn
