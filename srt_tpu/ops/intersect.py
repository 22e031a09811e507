"""Primitive intersection ops, batched over ray wavefronts.

Wavefront rewrites of the reference GLSL intersectors — instead of one ray
per shader invocation, every function is vectorized over an ``[N]`` ray batch
(and where applicable an ``[T]`` primitive batch), producing dense
``[N]``/``[N, T]`` arrays:

* spheres — ``SphereHit`` (shaders/raytrace_compute.glsl:93-120, RTiOW form)
* AABB slab test — ``IntersectsBox`` (shaders/ray_intersects.glsl:49-58),
  with the entry distance clamped for inside origins
* Moller-Trumbore triangles — ``IntersectsTriangle``
  (shaders/ray_intersects.glsl:61-96)

All ops are pure jnp and differentiable w.r.t. ray and primitive geometry.
"""

from __future__ import annotations

import jax.numpy as jnp

INF = jnp.float32(jnp.inf)
MT_PARALLEL_EPS = 1e-4   # ray-parallel epsilon (ray_intersects.glsl:73)
MT_HIT_EPS = 1e-5        # minimum hit distance  (ray_intersects.glsl:89)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def sphere_hit(origins, dirs, centers, radii, t_min, t_max):
    """Closest sphere hit per ray.

    origins/dirs: [3, N] (component-first wavefront layout, ops/vec.py);
    centers: [S, 3]; radii: [S].
    Returns (hit [N] bool, t [N], idx [N] int32).  Mirrors the quadric form
    of ``SphereHit`` + the closest-hit loop in ``CheckHit``
    (raytrace_compute.glsl:93-141): the near root is taken if inside
    (t_min, t_max), else the far root.
    """
    ct = centers.T                                           # [3, S]
    oc = ct[:, :, None] - origins[:, None, :]                # [3, S, N]
    a = jnp.sum(dirs * dirs, axis=0)[None, :]                # [1, N]
    h = jnp.sum(dirs[:, None, :] * oc, axis=0)               # [S, N]
    c = jnp.sum(oc * oc, axis=0) - (radii * radii)[:, None]  # [S, N]
    t_max = jnp.broadcast_to(jnp.asarray(t_max)[None], h.shape)
    disc = h * h - a * c
    valid = disc >= 0.0
    # Double-where so the masked-out sqrt sees a positive argument: the
    # derivative of sqrt at 0 is inf, and 0-cotangent * inf = NaN would
    # otherwise poison gradients of secondary rays (whose origins and
    # directions depend on scene parameters).
    sqrtd = jnp.sqrt(jnp.where(valid, disc, 1.0))
    root_near = (h - sqrtd) / a
    root_far = (h + sqrtd) / a
    near_ok = (t_min < root_near) & (root_near < t_max)
    far_ok = (t_min < root_far) & (root_far < t_max)
    root = jnp.where(near_ok, root_near, root_far)
    valid = valid & (near_ok | far_ok)
    t_all = jnp.where(valid, root, INF)                      # [S, N]
    idx = jnp.argmin(t_all, axis=0).astype(jnp.int32)        # [N]
    t = jnp.min(t_all, axis=0)
    return jnp.isfinite(t), t, idx


def sphere_normal(p, center, radius, dirs):
    """Outward normal flipped to face the ray (``SetFaceNormal``,
    raytrace_utils.glsl:23-26).  p/center/dirs [3, N]; radius [N].
    Returns (normal [3, N], front_face [N])."""
    outward = (p - center) / radius[None, :]
    front = jnp.sum(dirs * outward, axis=0) < 0.0
    return jnp.where(front[None, :], outward, -outward), front


def box_entry(origins, dirs, bmin, bmax):
    """Slab test for BVH culling: the distance at which the ray enters the
    box (0 when the origin is inside), INF when it misses the box or the
    box lies behind the origin.

    origins/dirs: [..., 3]; bmin/bmax broadcastable to [..., 3].  Follows
    ``IntersectsBox`` (ray_intersects.glsl:49-58) except for an inside
    origin, where the reference returns the EXIT distance: a walk that
    prunes boxes against the best hit then skips a box holding a nearer
    hit, which loses hits of rays that start inside the scene (every
    bounce).  Division by zero direction components yields +/-inf; a NaN
    slab (origin on the plane of an axis-parallel ray) is dropped by
    fmin/fmax, which keeps the box — the GPU kernel's rule as well.
    """
    inv = 1.0 / dirs
    t0 = (bmin - origins) * inv
    t1 = (bmax - origins) * inv
    lo, hi = jnp.fmin(t0, t1), jnp.fmax(t0, t1)
    t_near = jnp.fmax(jnp.fmax(lo[..., 0], lo[..., 1]), lo[..., 2])
    t_far = jnp.fmin(jnp.fmin(hi[..., 0], hi[..., 1]), hi[..., 2])
    return jnp.where((t_near <= t_far) & (t_far >= 0.0),
                     jnp.maximum(t_near, 0.0), INF)


def moller_trumbore(origins, dirs, v0, v1, v2):
    """Dense ray x triangle Moller-Trumbore.

    origins/dirs: [N, 3]; v0/v1/v2: [T, 3].
    Returns (t [N, T] with INF for miss, u [N, T], v [N, T]).
    Matches ``IntersectsTriangle`` (ray_intersects.glsl:61-96): parallel
    epsilon 1e-4, hit epsilon 1e-5; barycentrics u toward v1, v toward v2.
    The caller takes the min over T for the closest hit.
    """
    e1 = v1 - v0                                             # [T, 3]
    e2 = v2 - v0
    h = jnp.cross(dirs[:, None, :], e2[None, :, :])          # [N, T, 3]
    a = _dot(e1[None, :, :], h)                              # [N, T]
    parallel = jnp.abs(a) < MT_PARALLEL_EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = origins[:, None, :] - v0[None, :, :]                 # [N, T, 3]
    u = f * _dot(s, h)
    q = jnp.cross(s, e1[None, :, :])                         # [N, T, 3]
    v = f * _dot(dirs[:, None, :], q)
    t = f * _dot(e2[None, :, :], q)
    miss = parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0) \
        | (t <= MT_HIT_EPS)
    return jnp.where(miss, INF, t), u, v


def closest_triangle_hit(origins, dirs, v0, v1, v2, t_max):
    """Closest triangle per ray from a dense MT sweep.

    Returns (hit [N], t [N], tri_idx [N] int32).  ``t_max`` ([N] or scalar)
    bounds the search like ``ray.intersection_distance``
    (raytrace_compute.glsl:131).
    """
    t_all, _, _ = moller_trumbore(origins, dirs, v0, v1, v2)
    t_all = jnp.where(t_all < jnp.broadcast_to(jnp.asarray(t_max)[..., None], t_all.shape),
                      t_all, INF)
    idx = jnp.argmin(t_all, axis=1).astype(jnp.int32)
    t = jnp.min(t_all, axis=1)
    return jnp.isfinite(t), t, idx


def triangle_geometric_normal(v0, v1, v2):
    """Unit geometric normal, ``normalize(cross(e1, e2))``
    (ray_intersects.glsl:90); degenerate triangles (padding) yield zero
    instead of NaN."""
    from srt_tpu.ops.safemath import safe_normalize
    return safe_normalize(jnp.cross(v1 - v0, v2 - v0))
