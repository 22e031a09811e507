"""Mesh pipeline tests: OBJ round-trip, BVH build, traversal agreement, and
the crafted-ray integration scenario from the reference
(BVH_intergration_tests.cpp: odd rays hit, even rays miss, then move the
model matrix and everything misses)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.models import mesh as mesh_mod
from srt_tpu.models import pathtracer
from srt_tpu.scene import model_scene_lights
from srt_tpu.utils import procgen
from srt_tpu.utils.bvh import bvh_depth, triangle_bvh, validate_bvh
from srt_tpu.utils.flatten import flatten_models, set_frame
from srt_tpu.utils.obj_loader import load_object

REF_RUBIK = "/root/reference/objects/Rubik/Rubik.obj"


def random_rays(n, seed, spread=4.0, target=(0, 0, 0)):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    origins += np.sign(origins) * 2.0  # keep origins outside the model
    dirs = np.asarray(target, np.float32)[None] - origins
    dirs += rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    # Component-first wavefront layout (ops/vec.py): rays are [3, N].
    return jnp.asarray(origins).T, jnp.asarray(dirs).T


def test_bvh_build_valid():
    mesh = procgen.uv_sphere(16, 24)
    bvh = triangle_bvh(mesh.positions, mesh.tri_vidx)
    validate_bvh(bvh, np.zeros((mesh.num_triangles, 3)))
    assert bvh.num_nodes <= 2 * mesh.num_triangles - 1
    assert bvh_depth(bvh) < 64
    # Root bounds contain all vertices.
    np.testing.assert_array_compare(
        lambda a, b: a <= b + 1e-6, bvh.node_min[0], mesh.positions.min(0)
    )


@pytest.mark.parametrize("mesh_name", ["cube", "rubik", "sphere"])
def test_bvh_traversal_matches_dense(mesh_name):
    mesh = {
        "cube": lambda: procgen.cube(),
        "rubik": lambda: procgen.rubik_grid(),
        "sphere": lambda: procgen.uv_sphere(8, 12),
    }[mesh_name]()
    scene = mesh_mod.upload(flatten_models([mesh]))
    o, d = random_rays(256, seed=1)
    t_max = jnp.full((256,), jnp.inf)

    td, id_, ud, vd = mesh_mod._dense_model_hit(scene, 0, o, d, t_max)
    tb, ib = mesh_mod._bvh_model_hit(scene, 0, o, d, t_max)

    hit_d = np.isfinite(np.asarray(td))
    hit_b = np.asarray(ib) != -1
    np.testing.assert_array_equal(hit_d, hit_b)
    np.testing.assert_allclose(
        np.asarray(td)[hit_d], np.asarray(tb)[hit_b], rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(id_)[hit_d], np.asarray(ib)[hit_b])


def test_crafted_rays_hit_then_model_moved_misses():
    """The reference integration test in wavefront form
    (BVH_intergration_tests.cpp:63-113): 64 crafted rays, odd aimed at the
    model and hitting, even aimed away and missing; then a model-matrix
    translation makes everything miss."""
    mesh = procgen.rubik_grid()
    flat = flatten_models([mesh])
    scene = mesh_mod.upload(flat)

    n = 64
    origins = np.zeros((n, 3), np.float32)
    dirs = np.zeros((n, 3), np.float32)
    origins[:, 2] = 10.0
    dirs[1::2] = (0.0, 0.0, -1.0)   # odd rays -> model at origin
    dirs[0::2] = (0.0, 0.0, 1.0)    # even rays -> away
    hit_fn = mesh_mod.mesh_hit_fn(scene, method="bvh")
    rec = hit_fn(jnp.asarray(origins).T, jnp.asarray(dirs).T, 1e-3,
                 jnp.full((n,), jnp.inf))
    hits = np.asarray(rec.hit)
    assert hits[1::2].all(), "odd rays must hit the model"
    assert not hits[0::2].any(), "even rays must miss"

    # UpdateModelMatrix analog: translate the model out of the rays' path.
    moved = np.eye(4, dtype=np.float32)
    moved[0, 3] = 100.0  # world->model: x_m = x_w + 100
    scene2 = mesh_mod.upload(set_frame(flat, 0, moved))
    rec2 = mesh_mod.mesh_hit_fn(scene2, method="bvh")(
        jnp.asarray(origins).T, jnp.asarray(dirs).T, 1e-3,
        jnp.full((n,), jnp.inf)
    )
    assert not np.asarray(rec2.hit).any(), "moved model must not be hit"


def test_obj_roundtrip(tmp_path):
    mesh = procgen.rubik_grid()
    path = str(tmp_path / "rubik_grid.obj")
    procgen.write_obj(path, mesh)
    loaded = load_object(path)
    assert loaded.num_triangles == mesh.num_triangles
    # Vertex positions in triangle order agree.
    np.testing.assert_allclose(
        loaded.positions[loaded.tri_vidx.reshape(-1)],
        mesh.positions[mesh.tri_vidx.reshape(-1)],
        rtol=1e-5, atol=1e-6,
    )
    assert len(loaded.materials) == len(mesh.materials)
    d0 = [m.diffuse for m in loaded.materials]
    assert any(np.allclose(d, (0.9, 0.1, 0.1)) for d in d0)


@pytest.mark.skipif(not os.path.exists(REF_RUBIK), reason="reference assets absent")
def test_reference_rubik_parses():
    """Parity fixture: the reference Rubik OBJ (216 tri + 486 quad faces ->
    1188 triangles, 7 materials — SURVEY.md section 4 fixtures)."""
    mesh = load_object(REF_RUBIK)
    assert mesh.num_triangles == 1188
    assert len(mesh.materials) == 7
    scene = mesh_mod.upload(flatten_models([mesh]))
    # Render a thumbnail and check it hits the model.
    o, d = random_rays(128, seed=5)
    rec = mesh_mod.mesh_hit_fn(scene, method="dense")(
        o, d, 1e-3, jnp.full((128,), jnp.inf)
    )
    assert np.asarray(rec.hit).sum() > 10


def test_mesh_render_smoke_dense_vs_bvh():
    mesh = procgen.cube(size=2.0)
    scene = mesh_mod.upload(flatten_models([mesh]))
    cam = CameraConfig(width=16, height=12, origin=(0, 1, 5), look_at=(0, 0, 0))
    cfg = RenderConfig(max_depth=2, rr_bounces=1)
    lights = model_scene_lights()
    key = jax.random.key(0)

    img_d = pathtracer.render(
        mesh_mod.mesh_hit_fn(scene, method="dense"), lights, cam, cfg, key
    )
    img_b = pathtracer.render(
        mesh_mod.mesh_hit_fn(scene, method="bvh"), lights, cam, cfg, key
    )
    assert np.isfinite(np.asarray(img_d)).all()
    np.testing.assert_allclose(np.asarray(img_d), np.asarray(img_b),
                               rtol=1e-4, atol=1e-5)
    # The cube must actually appear (not all sky).
    assert np.asarray(img_d).std() > 0.01


def test_multi_model_scene():
    """Two models with different frames resolve to the closest hit across
    models, like the bvh loop in CheckHit (raytrace_compute.glsl:144-161)."""
    cube1 = procgen.cube(size=1.0)
    cube2 = procgen.cube(size=1.0)
    f1 = np.eye(4, dtype=np.float32)          # at origin
    f2 = np.eye(4, dtype=np.float32)
    f2[2, 3] = 3.0                             # world->model z+3 => model at z=-3
    flat = flatten_models([cube1, cube2], frames=[f1, f2])
    scene = mesh_mod.upload(flat)

    o = jnp.asarray([[0.0, 0.0, 5.0]] * 2, jnp.float32).T
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 2, jnp.float32).T
    rec = mesh_mod.mesh_hit_fn(scene, method="dense")(
        o, d, 1e-3, jnp.full((2,), jnp.inf)
    )
    assert np.asarray(rec.hit).all()
    # Closest is the front face of the origin cube at z=0.5 -> t=4.5.
    np.testing.assert_allclose(np.asarray(rec.t), 4.5, rtol=1e-5)


def test_smooth_vertex_normals():
    """Smooth shading: per-corner normals (vn or computed) interpolate to
    near-analytic sphere normals at hit points; meshes without normals
    keep the geometric (faceted) normal — the reference's only behavior
    (it parses vn then packs pos+uv only, model_loader.cpp:296-331)."""
    from srt_tpu.utils.obj_loader import compute_vertex_normals

    mesh = procgen.uv_sphere(24, 36, radius=1.0)
    smooth = compute_vertex_normals(mesh)
    assert smooth.normals is not None
    # Computed vertex normals of a sphere are radial.
    ln = np.linalg.norm(smooth.normals, axis=1)
    radial = np.abs(np.sum(smooth.normals * mesh.positions, axis=1))
    good = ln > 0.5
    assert (radial[good] > 0.98).all()

    o = jnp.asarray([[0.1, 0.2, 5.0], [-0.4, 0.3, 5.0]], jnp.float32).T
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 2, jnp.float32).T
    tm = jnp.full((2,), jnp.inf)

    flat_scene = mesh_mod.upload(flatten_models([mesh]))
    sm_scene = mesh_mod.upload(flatten_models([smooth]))
    rec_f = mesh_mod.mesh_hit_fn(flat_scene)(o, d, 1e-3, tm)
    rec_s = mesh_mod.mesh_hit_fn(sm_scene)(o, d, 1e-3, tm)
    assert bool(rec_f.hit.all()) and bool(rec_s.hit.all())

    # Smooth normals align with the true sphere normal at the hit point.
    p = np.asarray(rec_s.p)
    true_n = p / np.linalg.norm(p, axis=0, keepdims=True)
    cos_s = np.sum(np.asarray(rec_s.normal) * true_n, axis=0)
    cos_f = np.sum(np.asarray(rec_f.normal) * true_n, axis=0)
    assert (cos_s > 0.999).all()
    # Flat shading is measurably less aligned (faceting).
    assert (cos_s >= cos_f - 1e-6).all() and cos_f.min() < 0.9999
