"""End-to-end sphere path tracing vs the numpy oracle.

The JAX-build analog of the reference's CPU-reference-renderer cross-check
(SURVEY.md section 3.3/4): identical injected uniforms drive both renderers
and images must agree to float tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.models import pathtracer, reference_cpu
from srt_tpu.ops import rng as rng_ops
from srt_tpu.scene import (
    default_sphere_scene,
    random_sphere_scene,
    sphere_scene_lights,
)


def oracle_scene(spheres, lights):
    m = spheres.materials
    return reference_cpu.OracleScene(
        centers=np.asarray(spheres.center),
        radii=np.asarray(spheres.radius),
        albedo=np.asarray(m.albedo),
        specular=np.asarray(m.specular),
        rough=np.asarray(m.roughness),
        metal=np.asarray(m.metalness),
        use_spec=np.asarray(m.use_spec),
        lpos=np.asarray(lights.position),
        lcol=np.asarray(lights.color),
        lint=np.asarray(lights.intensity),
    )


@pytest.mark.parametrize("sky_gradient", [False, True])
def test_image_matches_oracle(sky_gradient):
    cam = CameraConfig(width=24, height=16, origin=(0, 0, 0), look_at=(0, 0, -1))
    cfg = RenderConfig(max_depth=3, rr_bounces=2, sky_gradient=sky_gradient)
    spheres = default_sphere_scene()
    lights = sphere_scene_lights()

    n = cam.width * cam.height
    n_slots = rng_ops.total_slots(lights.count, cfg.max_depth + cfg.rr_bounces)
    uniforms = rng_ops.host_uniforms(seed=7, n_rays=n, n_slots=n_slots)

    img_jax = pathtracer.trace_with_uniforms(
        pathtracer.spheres_hit_fn(spheres), lights, cam, cfg,
        jnp.asarray(uniforms),
    )
    img_oracle = reference_cpu.render_image(
        oracle_scene(spheres, lights), cam.width, cam.height,
        cam.origin, cam.look_at, uniforms,
        max_depth=cfg.max_depth, rr_bounces=cfg.rr_bounces,
        sky_gradient=sky_gradient,
    )
    np.testing.assert_allclose(
        np.asarray(img_jax), img_oracle, rtol=2e-3, atol=2e-3
    )


def test_image_matches_oracle_random_scene():
    cam = CameraConfig(width=16, height=16, origin=(0, 1, 4), look_at=(0, 0, -1))
    cfg = RenderConfig(max_depth=4, rr_bounces=1)
    spheres = random_sphere_scene(12, seed=3)
    lights = sphere_scene_lights()

    n = cam.width * cam.height
    n_slots = rng_ops.total_slots(lights.count, cfg.max_depth + cfg.rr_bounces)
    uniforms = rng_ops.host_uniforms(seed=11, n_rays=n, n_slots=n_slots)

    img_jax = pathtracer.trace_with_uniforms(
        pathtracer.spheres_hit_fn(spheres), lights, cam, cfg,
        jnp.asarray(uniforms),
    )
    img_oracle = reference_cpu.render_image(
        oracle_scene(spheres, lights), cam.width, cam.height,
        cam.origin, cam.look_at, uniforms,
        max_depth=cfg.max_depth, rr_bounces=cfg.rr_bounces,
    )
    np.testing.assert_allclose(
        np.asarray(img_jax), img_oracle, rtol=2e-3, atol=2e-3
    )


def test_render_jit_and_finite():
    """Production path: threefry sampling under jit, finite output."""
    cam = CameraConfig(width=32, height=24)
    cfg = RenderConfig(max_depth=3, rr_bounces=1, spp=2)
    spheres = default_sphere_scene()
    lights = sphere_scene_lights()

    @jax.jit
    def go(key):
        return pathtracer.render_spheres(spheres, lights, cam, cfg, key)

    img = go(jax.random.key(0))
    assert img.shape == (24, 32, 3)
    assert bool(jnp.all(jnp.isfinite(img)))
    assert float(jnp.max(img)) > 0.01  # scene is lit


def test_render_deterministic():
    cam = CameraConfig(width=8, height=8)
    cfg = RenderConfig(max_depth=2, rr_bounces=1)
    spheres = default_sphere_scene()
    lights = sphere_scene_lights()
    a = pathtracer.render_spheres(spheres, lights, cam, cfg, jax.random.key(3))
    b = pathtracer.render_spheres(spheres, lights, cam, cfg, jax.random.key(3))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sort_bounces_is_bit_identical():
    """Wavefront re-sorting between bounces (RenderConfig.sort_bounces) is
    a pure performance transform: every pixel consumes the same uniforms
    and the scattered-back image is bit-identical."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.models import pathtracer
    from srt_tpu.ops import rng as rng_ops
    from srt_tpu.scene import default_sphere_scene, sphere_scene_lights

    cam = CameraConfig(width=16, height=12)
    cfg = RenderConfig(max_depth=3, rr_bounces=1)
    spheres = default_sphere_scene()
    lights = sphere_scene_lights()
    n = cam.width * cam.height
    n_slots = rng_ops.total_slots(lights.count, cfg.max_depth + cfg.rr_bounces)
    uniforms = jnp.asarray(rng_ops.host_uniforms(21, n, n_slots))

    hit = pathtracer.spheres_hit_fn(spheres)
    base = pathtracer.trace_with_uniforms(hit, lights, cam, cfg, uniforms)
    sorted_cfg = dataclasses.replace(cfg, sort_bounces=True)
    srt = pathtracer.trace_with_uniforms(hit, lights, cam, sorted_cfg, uniforms)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(srt))
