"""Per-ray BVH traversal on an NVIDIA GPU (the ``"cuda"`` mesh strategy).

The kernel (native/bvh_traverse.cu) walks one ray per thread through one
model's flattened BVH with a fixed per-thread stack, nearer child first —
the reference's ``Intersects`` loop (ray_intersects.glsl:99-133).  It is
called as an XLA custom call through ``jax.ffi`` and is a pure candidate
search: it returns the winning triangle and its fp32 ``t``, and
``models/mesh.mesh_hit_fn`` re-derives exact, differentiable (t, u, v)
for the winner.  Every operand is ``stop_gradient``'d, so ``jax.grad``
passes the call by (its inputs carry no tangents).

The shared library is built from the committed sources on first use
(``make -C native cuda``, nvcc for sm_90a) into ``native/build/``.  There
is no fallback: on a GPU a failed build raises, and on any other platform
asking for this strategy raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libsrt_bvh_cuda.so")
TARGET = "srt_bvh_traverse"
MAX_STACK = 64          # kMaxStack in bvh_traverse.cu
NODE_WORDS = 8          # one 32-byte record per node
TRI_WORDS = 12          # v0, e1, e2 as three 16-byte rows


def pack_tables(node_min, node_max, node_first, node_count, v0, v1, v2):
    """The kernel's tables, from the scene's BVH and triangle arrays.

    nodes [Nn, 8] f32: ``min.xyz, bits(first), max.xyz, bits(count)`` —
    one node is two 16-byte loads; the int32 fields are stored bit-exact.
    tris [T, 12] f32: ``v0.xyz, 0, e1.xyz, 0, e2.xyz, 0`` in BVH order,
    with ``e1 = v1 - v0`` and ``e2 = v2 - v0`` computed exactly as the
    Moller-Trumbore test of the other strategies computes them.
    jnp throughout, so ``mesh.refit_accel`` repacks under jit.
    """
    bits = lambda x: jax.lax.bitcast_convert_type(
        jnp.asarray(x, jnp.int32), jnp.float32)[:, None]
    nodes = jnp.concatenate(
        [node_min, bits(node_first), node_max, bits(node_count)], axis=1)
    zero = jnp.zeros((v0.shape[0], 1), jnp.float32)
    tris = jnp.concatenate([v0, zero, v1 - v0, zero, v2 - v0, zero], axis=1)
    return nodes.astype(jnp.float32), tris.astype(jnp.float32)


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU."""
    platform = jax.default_backend()
    if platform != "gpu":
        raise RuntimeError(
            f"the 'cuda' traversal strategy needs a GPU; JAX's backend is "
            f"{platform!r} (use mesh.default_method() to pick one)")


def build() -> str:
    """Compile the kernel library from the committed sources if it is
    missing or older than them; returns its path.  Raises on failure."""
    newest = max(os.path.getmtime(os.path.join(_NATIVE_DIR, f))
                 for f in ("bvh_traverse.cu", "Makefile"))
    if (not os.path.exists(LIB_PATH)
            or os.path.getmtime(LIB_PATH) < newest):
        proc = subprocess.run(
            ["make", "-C", _NATIVE_DIR, "cuda",
             f"FFI_INCLUDE={jax.ffi.include_dir()}"],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {LIB_PATH} failed:\n{proc.stdout}\n{proc.stderr}")
    return LIB_PATH


@functools.cache
def _register() -> None:
    """Build (if needed), load and register the kernel, once a process."""
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.SrtBvhTraverse), platform="CUDA")


def traverse(nodes, tris, origins, dirs, t_max, root: int,
             stack_depth: int, any_hit: bool = False, t_min: float = 0.0):
    """Run the kernel: origins/dirs [3, N] in model space, t_max [N].

    Returns (t [N] f32, tri [N] int32, -1 = miss).  Closest-hit mode keeps
    the nearest hit below ``t_max`` with ``t > MT_HIT_EPS`` (``t_min`` is
    the caller's filter, as for the other strategies); any-hit mode returns
    the first hit found in ``(t_min, t_max)``.
    """
    require_gpu()
    if not 1 <= stack_depth <= MAX_STACK:
        raise ValueError(f"BVH too deep for the kernel stack: "
                         f"{stack_depth} > {MAX_STACK}")
    _register()
    sg = jax.lax.stop_gradient
    n = origins.shape[1]
    call = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((n,), jnp.float32),
         jax.ShapeDtypeStruct((n,), jnp.int32)),
        vmap_method="sequential")
    return call(
        sg(nodes), sg(tris),
        sg(jnp.asarray(origins, jnp.float32)),
        sg(jnp.asarray(dirs, jnp.float32)),
        sg(jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))),
        root=np.int32(root), stack_depth=np.int32(stack_depth),
        any_hit=np.int32(bool(any_hit)), t_min=np.float32(t_min))
