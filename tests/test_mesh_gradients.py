"""Mesh gradients end-to-end: vertex / material / frame gradients,
candidate-search (bvh) differentiability, shared-vertex scatter-back, and a vertex-recovery
inverse-rendering demo (BASELINE config 4: "vertex + material gradients").

Same stance as test_gradients.py: discrete decisions are fixed by injected
uniforms, geometry FD checks mask to decision-stable pixels (silhouette
boundary terms are handled separately, see test_visibility_gradients.py).
"""

import jax
import jax.numpy as jnp
import numpy as np

from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.models import mesh as mesh_mod
from srt_tpu.models import pathtracer, wavefront
from srt_tpu.ops import rng as rng_ops
from srt_tpu.scene import model_scene_lights
from srt_tpu.utils import procgen
from srt_tpu.utils.flatten import flatten_models

CAM = CameraConfig(width=12, height=10, origin=(0.0, 0.5, 4.0),
                   look_at=(0.0, 0.0, 0.0))
CFG = RenderConfig(max_depth=2, rr_bounces=0)


def setup(pad_to=128):
    mesh = procgen.uv_sphere(6, 8, radius=1.0)
    scene = mesh_mod.upload(flatten_models([mesh], pad_to=pad_to))
    lights = model_scene_lights()
    n = CAM.width * CAM.height
    n_slots = rng_ops.total_slots(lights.count, CFG.max_depth + CFG.rr_bounces)
    uniforms = rng_ops.host_uniforms(seed=7, n_rays=n, n_slots=n_slots)
    return scene, lights, jnp.asarray(uniforms)


def render_mesh(scene, lights, uniforms, method="dense"):
    return pathtracer.trace_with_uniforms(
        mesh_mod.mesh_hit_fn(scene, method=method), lights, CAM, CFG, uniforms
    )


def test_bvh_render_is_differentiable_and_matches_dense():
    """jax.grad through method="bvh": finite, nonzero, and equal to the
    dense-path gradients — the walk is a pure candidate search on
    stop_gradient'd operands (a while_loop has no reverse-mode rule), so
    gradients flow through the exact refine, as for the GPU kernel."""
    scene, lights, uniforms = setup()

    def loss(diffuse, method):
        s = scene.replace(mat_diffuse=diffuse)
        return jnp.mean(render_mesh(s, lights, uniforms, method=method))

    g_bvh = jax.grad(lambda d: loss(d, "bvh"))(scene.mat_diffuse)
    g_dense = jax.grad(lambda d: loss(d, "dense"))(scene.mat_diffuse)
    assert np.isfinite(np.asarray(g_bvh)).all()
    assert np.abs(np.asarray(g_bvh)).max() > 1e-6
    np.testing.assert_allclose(np.asarray(g_bvh), np.asarray(g_dense),
                               rtol=1e-4, atol=1e-7)


def test_bvh_vertex_grads_match_dense():
    """Shared-vertex gradients (scatter-back through tri_vidx) agree
    between the bvh and dense strategies."""
    scene, lights, uniforms = setup()

    def loss(positions, method):
        s = mesh_mod.with_positions(scene, positions)
        return jnp.mean(render_mesh(s, lights, uniforms, method=method))

    g_bvh = jax.grad(lambda p: loss(p, "bvh"))(scene.positions)
    g_dense = jax.grad(lambda p: loss(p, "dense"))(scene.positions)
    assert np.isfinite(np.asarray(g_bvh)).all()
    assert np.abs(np.asarray(g_bvh)).max() > 1e-6
    np.testing.assert_allclose(np.asarray(g_bvh), np.asarray(g_dense),
                               rtol=1e-4, atol=1e-6)


def _primary_ids(scene, uniforms):
    """Primary-hit triangle id per pixel (decision-stability probe)."""
    from srt_tpu.camera import derive_viewport, generate_rays
    vp = derive_viewport(CAM)
    o, d = generate_rays(vp, CAM.width, CAM.height, uniforms[:, :2].T)
    ids, _ = wavefront.hit_ids(scene, np.asarray(o).T, np.asarray(d).T,
                               t_min=CFG.t_min)
    return np.asarray(ids)


def test_vertex_grad_matches_fd_on_stable_pixels():
    scene, lights, uniforms = setup()
    eps = 1e-3
    # Vertex nearest the camera-facing pole: visible, well-lit.
    vi = int(np.argmax(np.asarray(scene.positions) @ np.array([0.0, 0.2, 1.0])))

    def perturb(dz):
        p = scene.positions.at[vi, 2].add(dz)
        return mesh_mod.with_positions(scene, p)

    i0 = _primary_ids(perturb(0.0), uniforms)
    ip = _primary_ids(perturb(eps), uniforms)
    im = _primary_ids(perturb(-eps), uniforms)
    stable = (i0 == ip) & (i0 == im)
    assert stable.sum() > 60  # most pixels are decision-stable
    mask = jnp.asarray(stable, jnp.float32)[:, None]

    def loss(dz):
        img = render_mesh(perturb(dz), lights, uniforms)
        return jnp.sum(img.reshape(-1, 3) * mask) / stable.sum()

    g = jax.grad(loss)(jnp.float32(0.0))
    fd = (float(loss(jnp.float32(eps))) - float(loss(jnp.float32(-eps)))) / (2 * eps)
    assert np.isfinite(float(g))
    assert abs(float(g) - fd) <= 2e-2 * max(1.0, abs(fd)), (
        f"vertex z: analytic {float(g)} vs fd {fd}"
    )


def test_frame_grad_matches_fd_on_stable_pixels():
    """Pose gradients through the world->model frame matrix
    (the differentiable UpdateModelMatrix, gpu_loader.cpp:185-196)."""
    scene, lights, uniforms = setup()
    eps = 1e-3

    def perturb(dx):
        # world->model translation: moves the model by -dx in world x.
        return scene.replace(frames=scene.frames.at[0, 0, 3].add(dx))

    i0 = _primary_ids(perturb(0.0), uniforms)
    ip = _primary_ids(perturb(eps), uniforms)
    im = _primary_ids(perturb(-eps), uniforms)
    stable = (i0 == ip) & (i0 == im)
    assert stable.sum() > 60
    mask = jnp.asarray(stable, jnp.float32)[:, None]

    def loss(dx):
        img = render_mesh(perturb(dx), lights, uniforms)
        return jnp.sum(img.reshape(-1, 3) * mask) / stable.sum()

    g = jax.grad(loss)(jnp.float32(0.0))
    fd = (float(loss(jnp.float32(eps))) - float(loss(jnp.float32(-eps)))) / (2 * eps)
    assert np.isfinite(float(g))
    assert abs(float(g) - fd) <= 2e-2 * max(1.0, abs(fd)), (
        f"frame tx: analytic {float(g)} vs fd {fd}"
    )


def test_refit_accel_matches_host_tables():
    """jnp refit of an unmoved scene reproduces the host-built node
    bounds and kernel tables exactly, and stays exact under jit."""
    scene = mesh_mod.upload(flatten_models([procgen.cube()], pad_to=128))
    refit = jax.jit(mesh_mod.refit_accel)(scene)
    for name in ("node_min", "node_max", "bvh_nodes", "bvh_tris"):
        np.testing.assert_array_equal(np.asarray(getattr(refit, name)),
                                      np.asarray(getattr(scene, name)),
                                      err_msg=name)


def test_inverse_rendering_recovers_perturbed_vertex():
    """End-to-end demo: gradient descent pulls a displaced vertex back
    toward the pose that produced the target image."""
    import optax
    scene, lights, uniforms = setup()
    target = render_mesh(scene, lights, uniforms)

    vi = int(np.argmax(np.asarray(scene.positions) @ np.array([0.0, 0.2, 1.0])))
    p_true = np.asarray(scene.positions)[vi].copy()
    p0 = scene.positions.at[vi].add(jnp.asarray([0.05, -0.04, 0.06]))

    def loss_fn(positions):
        img = render_mesh(mesh_mod.with_positions(scene, positions),
                          lights, uniforms)
        return jnp.mean((img - target) ** 2)

    opt = optax.adam(2e-2)
    state = opt.init(p0)
    p = p0

    @jax.jit
    def step(p, state):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, state = opt.update(g, state, p)
        return optax.apply_updates(p, updates), state, loss

    l0 = float(loss_fn(p0))
    err0 = float(np.linalg.norm(np.asarray(p0)[vi] - p_true))
    for _ in range(30):
        p, state, loss = step(p, state)
    l1 = float(loss)
    err1 = float(np.linalg.norm(np.asarray(p)[vi] - p_true))
    assert l1 < 0.3 * l0, f"loss {l0:.3e} -> {l1:.3e}"
    assert err1 < 0.6 * err0, f"vertex error {err0:.4f} -> {err1:.4f}"
