"""Morton (Z-order) ray permutation for wavefront coherence.

The reference dispatches pixels in 8x8 workgroups (raytrace_compute.glsl:12,
src/main.cpp:706), which is itself a locality trick: rays in a workgroup
take similar BVH paths.  The analogous trick for a ray wavefront is to
order rays along a Morton curve: a block of 512 consecutive rays (e.g. the
warps of a few GPU thread blocks) then covers a compact ~32x16 pixel block
instead of a full image row:

* neighbouring rays walk similar BVH nodes -> less divergence and better
  cache reuse in the traversal;
* terminated paths cluster spatially (paths die where the scene is empty),
  so whole tiles go dead together and are skipped outright by the kernel's
  all-dead early-out (t_max == 0 lanes).

Correctness is exact: the permutation is applied to the rays *and* to every
uniform block drawn from the RNG stream (``PermutedStream``), so each pixel
consumes exactly the same random numbers as in pixel order and the final
(un-permuted) image is bit-identical — oracle-parity tests are unaffected.
"""

from __future__ import annotations

import functools

import numpy as np


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the low 16 bits of x so there is a 0 between each bit."""
    x = x.astype(np.uint32) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


@functools.lru_cache(maxsize=32)
def morton_perm(height: int, width: int):
    """Pixel permutation along the Z-order curve for an H x W image.

    Returns (perm, inv) int32 numpy arrays of length H*W such that
    ``rays_morton = rays[:, perm]`` and ``image = out[:, inv]``.  Works for
    any H, W (codes are argsorted, so non-power-of-two sizes just skip the
    absent cells of the virtual square grid); the sort is stable, so for
    degenerate sizes this degrades gracefully to row-major order.
    """
    ys, xs = np.meshgrid(
        np.arange(height, dtype=np.uint32),
        np.arange(width, dtype=np.uint32),
        indexing="ij",
    )
    code = (_part1by1(ys) << 1) | _part1by1(xs)
    perm = np.argsort(code.reshape(-1), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


class PermutedStream:
    """Wrap a KeyStream/ArrayStream so slot blocks come out in ray
    (permuted) order while the underlying stream stays in pixel order —
    pixel p consumes exactly the same numbers either way.

    The stream protocol is take-only (``take(k) -> [k, N]``, ops/rng.py);
    any other attribute access raises so a future stream method can never
    silently bypass the permutation and break bit-exactness."""

    def __init__(self, base, perm):
        self._base = base
        self._perm = perm

    def take(self, k: int):
        return self._base.take(k)[:, self._perm]

    def __getattr__(self, name):
        raise AttributeError(
            f"PermutedStream forwards only take(); draw method {name!r} "
            "would bypass the ray permutation (ops/morton.py)"
        )


def permute_rays(origins, dirs, perm):
    """Apply a ray permutation to [3, N] origin/direction pairs via ONE
    row-major gather on a packed [N, 6] array instead of six gathers
    along the minor axis of the component-first arrays."""
    import jax.numpy as jnp

    packed = jnp.concatenate([origins, dirs], axis=0).T[perm].T
    return packed[0:3], packed[3:6]


def unpermute_image(radiance, inv):
    """Inverse-permute [3, N] radiance back to pixel order (row-major
    gather; see permute_rays)."""
    return radiance.T[inv].T
