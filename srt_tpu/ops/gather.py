"""Gather replacements for small static tables.

For *small static tables* (lights, sphere materials, per-model frames) an
unrolled ``jnp.where`` select-chain replaces ``table[idx]``: it fuses into
neighboring elementwise work instead of materializing a gather.  Whether
that wins on the GPU is not measured yet (ROADMAP).

The reference had no such concern: GLSL SSBO indexing is a hardware gather
(e.g. the light loop at shaders/raytrace_compute.glsl:185-202 indexes
``lights[idx]`` directly).
"""

from __future__ import annotations

import jax.numpy as jnp

# Above this many rows the where-chain loses to a real gather.
SELECT_LIMIT = 16


def take_small(table: jnp.ndarray, idx: jnp.ndarray,
               limit: int = SELECT_LIMIT) -> jnp.ndarray:
    """``table[idx]`` for a small static leading dimension.

    table: [K, ...]; idx: [N] int; returns [N, ...].  Falls back to a real
    gather when K > limit.
    """
    k = table.shape[0]
    if k > limit:
        return table[idx]
    out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    for i in range(1, k):
        mask = (idx == i).reshape(idx.shape + (1,) * (table.ndim - 1))
        out = jnp.where(mask, table[i], out)
    return out


def take_small_t(table: jnp.ndarray, idx: jnp.ndarray,
                 limit: int = SELECT_LIMIT) -> jnp.ndarray:
    """Component-first gather: table [K, C], idx [N] -> [C, N].

    The wavefront layout keeps per-ray vectors as [C, N] (rays on the lane
    axis); this gathers straight into that layout so no padded [N, C]
    intermediate is ever materialized.
    """
    k = table.shape[0]
    if k > limit:
        return table[idx].T
    out = jnp.broadcast_to(table[0][:, None], (table.shape[1], idx.shape[0]))
    for i in range(1, k):
        out = jnp.where(idx[None, :] == i, table[i][:, None], out)
    return out
