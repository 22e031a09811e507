"""srt_tpu — a differentiable wavefront path tracer in JAX, for NVIDIA GPUs.

A JAX/XLA framework with the capabilities of the reference
C++/OpenGL compute path tracer ``matteobir12/simple-ray-tracer`` (see
SURVEY.md): GGX microfacet path tracing with RIS light sampling and Russian
roulette, sphere and OBJ/MTL triangle-mesh scenes, CPU-built BVHs flattened
for per-ray traversal, and progressive sample accumulation — redesigned
as batched array programs:

* every render stage (ray gen, intersection/traversal, BRDF shading,
  accumulation) is a pure, differentiable JAX function over wavefront-style
  ray *batches* (``[N, ...]`` arrays), not a megakernel over texels;
* the hot traversal is one CUDA kernel (one thread per ray, fixed-stack
  BVH walk) called through ``jax.ffi`` (``srt_tpu.ops.traversal_cuda``);
* random sampling is counter-based (threefry) instead of the reference's
  noise-texture hash (``shaders/raytrace_utils.glsl:28-89``);
* scaling is a ``jax.sharding.Mesh`` over devices with rays sharded and
  the scene replicated (``srt_tpu.parallel``), not GL dispatch.

Layout:
  srt_tpu.config     — render/camera configuration dataclasses
  srt_tpu.scene      — scene pytrees (spheres, meshes, lights, materials)
  srt_tpu.camera     — viewport derivation, ray generation, FPS controls
  srt_tpu.ops        — device kernels: intersect, traversal, brdf, rng, ...
  srt_tpu.models     — renderers: wavefront path tracer, CPU oracle
  srt_tpu.parallel   — device mesh, sharded rendering, multi-host
  srt_tpu.utils      — OBJ/MTL loader, BVH build, atlas, images, checkpoints
  srt_tpu.optim      — inverse-rendering optimizer driver
  srt_tpu.app        — progressive interactive-style render session
"""

__version__ = "0.1.0"

from srt_tpu import config as config
from srt_tpu import scene as scene
from srt_tpu import camera as camera
