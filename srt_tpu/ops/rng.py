"""Counter-based random sampling for path tracing.

Replaces the reference's noise-texture hash RNG
(shaders/raytrace_utils.glsl:28-89 — a fract-sin hash indexing two
precomputed W*H noise texture-buffers, visibly correlated because seeds are
hit-position based and reused).  Here sampling is threefry counter-based:
per-(pixel, sample, bounce, slot) decorrelated, deterministic, and
reproducible across hosts — no giant noise buffers in memory.

Two interchangeable stream implementations feed the renderer:

* ``KeyStream`` — draws from ``jax.random`` inside jit (production).
* ``ArrayStream`` — slices a caller-provided ``[N, D]`` uniform array
  (testing: the numpy oracle consumes the *same* array in the same slot
  order, making renderer-vs-oracle comparisons exact).

Streams yield ``[k, N]`` blocks (slot-major): the wavefront layout keeps the
ray axis minor so each slot row is contiguous (see ops/vec.py).

The slot protocol per path-tracing bounce (see models/pathtracer.py):
``[ris_idx x L | ris_sel x L | lobe | rr | diff_r1 | diff_r2 | h_r1 | h_r2]``
so a bounce consumes ``2*L + 6`` slots; pixel jitter (2 slots) is drawn
before the bounce loop.  With NEE enabled (``cfg.nee``; r5) each bounce
appends ``[nee_pick | nee_u1 | nee_u2]`` — strictly AFTER the base block,
so the base protocol and the numpy oracle are untouched when NEE is off.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def bounce_slots(n_lights: int, nee: bool = False) -> int:
    """Uniform slots consumed per bounce for a scene with n_lights
    lights.  ``nee=True`` appends 3 slots (emitter pick + 2 area
    coordinates) AFTER the base block, so the base protocol (and oracle
    parity) is unchanged when NEE is off."""
    return 2 * n_lights + 6 + (3 if nee else 0)


def total_slots(n_lights: int, n_bounces: int, nee: bool = False) -> int:
    """Total slots per path: pixel jitter + all bounces."""
    return 2 + n_bounces * bounce_slots(n_lights, nee)


class SlotBlock:
    """A reserved [k, n] uniform block that can be materialized either in
    full (``full()`` == ``jax.random.uniform(sub, (k, n))``) or row-slice
    by data-dependent columns (``rows_at``) WITHOUT a gather: the threefry
    counter lattice is evaluated directly at the requested (slot, column)
    indices: ~100 integer ops per element instead of a row gather of a
    pre-drawn uniform table.  Bit-equality with the gathered path is asserted by
    tests/test_features.py (it depends on jax's partitionable threefry
    layout: bits(j) = w0 ^ w1 of the (0, j) counter block)."""

    def __init__(self, key: jax.Array, k: int, n: int):
        self._key = key
        self._k = k
        self._n = n

    def full(self) -> jnp.ndarray:
        return jax.random.uniform(self._key, (self._k, self._n),
                                  dtype=jnp.float32)

    def rows_at(self, lo: int, hi: int, cols) -> jnp.ndarray:
        """``full()[lo:hi, cols]``, gather-free.  ``cols`` [m] int."""
        import jax.extend as jex
        m = cols.shape[0]
        j = (jnp.arange(lo, hi, dtype=jnp.uint32)[:, None] * self._n
             + cols.astype(jnp.uint32)[None, :]).reshape(-1)
        kd = jax.random.key_data(self._key)
        out = jex.random.threefry_2x32(
            kd, jnp.concatenate([jnp.zeros_like(j), j]))
        bits = out[:j.shape[0]] ^ out[j.shape[0]:]
        u = jax.lax.bitcast_convert_type(
            (bits >> 9) | jnp.uint32(0x3F800000), jnp.float32) - 1.0
        return u.reshape(hi - lo, m)


class KeyStream:
    """Threefry-backed uniform stream. Static slot counter, pure under jit."""

    def __init__(self, key: jax.Array, n_rays: int):
        self._key = key
        self._n = n_rays
        self._counter = 0

    def take_block(self, k: int) -> SlotBlock:
        """Reserve the next [k, n_rays] block (consumes one counter slot,
        exactly like ``take``) without materializing it."""
        sub = jax.random.fold_in(self._key, self._counter)
        self._counter += 1
        return SlotBlock(sub, k, self._n)

    def take(self, k: int) -> jnp.ndarray:
        """Draw [k, n_rays] uniforms in [0, 1)."""
        return self.take_block(k).full()


class _ArrayBlock:
    """SlotBlock API over an injected uniform block (oracle testing);
    ``rows_at`` falls back to a plain gather."""

    def __init__(self, u):
        self._u = u                                  # [k, N]

    def full(self):
        return self._u

    def rows_at(self, lo: int, hi: int, cols):
        return self._u[lo:hi].T[cols].T


class ArrayStream:
    """Slices a precomputed [N, D] uniform array by static offsets,
    yielding slot-major [k, N] blocks."""

    def __init__(self, uniforms):
        self._u = uniforms
        self._off = 0

    def take(self, k: int):
        u = self._u[:, self._off:self._off + k]
        self._off += k
        if u.shape[1] != k:
            raise ValueError(
                f"uniform array exhausted: need {k} slots at offset {self._off - k}, "
                f"have {self._u.shape[1]}"
            )
        return u.T

    def take_block(self, k: int) -> _ArrayBlock:
        return _ArrayBlock(self.take(k))


def host_uniforms(seed: int, n_rays: int, n_slots: int) -> np.ndarray:
    """Host-side uniforms for oracle comparisons (numpy, not jax)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n_rays, n_slots)).astype(np.float32)
