"""Sharded rendering and gradient reduction via shard_map.

Rays shard over the mesh's ``rays`` axis, spp samples over ``samples``,
the scene pytree is replicated (in_spec ``P()``), matching the reference's
whole-scene-per-device residency (gpu_loader.cpp:142-176) scaled across
devices.  shard_map's replication semantics make the backward pass psum the
scene-parameter cotangents across the mesh automatically — the gradient
all-reduce of SURVEY.md section 2.3, overlapped with backward compute by
XLA's scheduler.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from srt_tpu.camera import derive_viewport, generate_rays
from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.models.pathtracer import trace_wavefront
from srt_tpu.ops.rng import ArrayStream, total_slots
from srt_tpu.scene import Lights

from srt_tpu.parallel.mesh import RAYS_AXIS, SAMPLES_AXIS


def _draw_uniforms(key, n, n_lights, n_bounces):
    d = total_slots(n_lights, n_bounces)
    return jax.random.uniform(key, (n, d), dtype=jnp.float32)


def trace_sharded(make_hit_fn: Callable, scene, lights: Lights,
                  origins, dirs, uniforms, cfg: RenderConfig, mesh):
    """Trace a ray batch with rays sharded over the mesh.

    make_hit_fn(scene) -> HitFn; scene/lights replicated; origins, dirs,
    uniforms sharded on the rays axis.  N must divide the rays-axis size.
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        # Rays shard on their (minor) wavefront axis: origins/dirs/radiance
        # are [3, N] (ops/vec.py), uniforms [N, D].
        in_specs=(P(), P(), P(None, RAYS_AXIS), P(None, RAYS_AXIS),
                  P(RAYS_AXIS)),
        out_specs=P(None, RAYS_AXIS),
        check_vma=False,
    )
    def shard_body(scene_, lights_, o, d, u):
        stream = ArrayStream(u)
        stream.take(2)  # jitter slots consumed by the caller's ray gen
        return trace_wavefront(make_hit_fn(scene_), lights_, o, d, stream, cfg)

    return shard_body(scene, lights, origins, dirs, uniforms)


def render_sharded(make_hit_fn: Callable, scene, lights: Lights,
                   cam: CameraConfig, cfg: RenderConfig, key, mesh):
    """Full-image sharded render, spp-accumulated; linear [H, W, 3].

    Bit-identical to the single-device ``pathtracer.render`` given the same
    uniforms protocol is replayed per sample index (tested on the virtual
    CPU mesh).
    """
    n = cam.height * cam.width
    n_bounces = cfg.max_depth + cfg.rr_bounces

    def one_sample(s):
        k = jax.random.fold_in(key, s)
        uniforms = _draw_uniforms(k, n, lights.count, n_bounces)
        vp = derive_viewport(cam)
        origins, dirs = generate_rays(vp, cam.width, cam.height,
                                      uniforms[:, 0:2].T)
        radiance = trace_sharded(
            make_hit_fn, scene, lights, origins, dirs, uniforms, cfg, mesh
        )
        return radiance

    acc = jnp.zeros((3, n), jnp.float32)
    for s in range(cfg.spp):
        acc = acc + one_sample(s)
    return (acc / cfg.spp).T.reshape(cam.height, cam.width, 3)


def sharded_loss_and_grad(make_hit_fn: Callable, lights: Lights,
                          cam: CameraConfig, cfg: RenderConfig, mesh):
    """Build a jittable ``(scene, target, key) -> (loss, grads)``.

    L2 image loss; gradients w.r.t. every array leaf of ``scene``.  Because
    the scene enters the shard_map replicated, its cotangents are psum'd
    across the rays axis by construction — the multi-chip gradient
    all-reduce.
    """

    def loss_fn(scene, target, key):
        img = render_sharded(make_hit_fn, scene, lights, cam, cfg, key, mesh)
        return jnp.mean((img - target) ** 2)

    # allow_int: scene pytrees carry integer/bool leaves (use_spec flags,
    # triangle indices) that get float0 gradients.
    return jax.value_and_grad(loss_fn, allow_int=True)
