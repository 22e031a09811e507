"""Component-first vector math for ray wavefronts.

The wavefront layout for a batch of N 3-vectors is ``[3, N]`` — one
contiguous row per component, rays on the minor axis, so every
elementwise op reads and writes whole coalesced rows (see ARCHITECTURE.md,
"Layout").  Per-ray scalars are plain ``[N]``.

Conventions used across the shading path:

* vectors: ``[3, N]``; dot/cross/normalize reduce or act on axis 0;
* per-ray scalars broadcast against vectors as ``s[None, :]`` (written
  ``bc(s)`` here);
* small per-entity tables (lights, spheres, materials) stay ``[K, 3]`` on
  the host side and enter the wavefront as ``table[k][:, None]`` columns or
  via ``ops.gather.take_small_t``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bc(s):
    """Broadcast a per-ray scalar [N] against vectors [3, N]."""
    return s[None, :]


def dot(a, b):
    """Component-axis dot: [3, N] x [3, N] -> [N]."""
    return jnp.sum(a * b, axis=0)


def cross(a, b):
    """Cross product along axis 0: [3, N] x [3, N] -> [3, N]."""
    return jnp.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def norm2(v):
    """Squared length [N]."""
    return jnp.sum(v * v, axis=0)


def normalize(v, fallback=None):
    """Gradient-safe unit vector along axis 0 (zero-length passes through,
    contributing no NaN cotangent — see ops/safemath.py)."""
    s = norm2(v)
    ok = s > 0.0
    inv = jax.lax.rsqrt(jnp.where(ok, s, 1.0))
    out = v * jnp.where(ok, inv, 1.0)[None, :]
    if fallback is not None:
        out = jnp.where(ok[None, :], out, fallback)
    return out


def v3(x, y, z):
    """Constant column vector [3, 1] for broadcasting against [3, N]."""
    return jnp.asarray([[x], [y], [z]], jnp.float32)


def col(v):
    """[3] table row -> [3, 1] broadcast column."""
    return jnp.asarray(v, jnp.float32).reshape(3, 1)
