"""Feature coverage: wavefront hit-id API, defocus blur, textured meshes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.models import mesh as mesh_mod
from srt_tpu.models import pathtracer, wavefront
from srt_tpu.ops.texture import sample_atlas
from srt_tpu.scene import default_sphere_scene, model_scene_lights, sphere_scene_lights
from srt_tpu.utils import procgen
from srt_tpu.utils.atlas import build_atlas_for_materials, pack_atlas
from srt_tpu.utils.flatten import flatten_models
from srt_tpu.utils.obj_loader import MaterialDef


def test_wavefront_hit_ids():
    """The reference wavefront-kernel contract: explicit rays in, global
    triangle ids out, uint(-1) for miss (ray_intersects.glsl:135-161)."""
    scene = mesh_mod.upload(flatten_models([procgen.cube(size=2.0)]))
    o = jnp.asarray([[0, 0, 5], [0, 0, 5], [5, 5, 5]], jnp.float32)
    d = jnp.asarray([[0, 0, -1], [0, 0, 1], [1, 1, 1]], jnp.float32)
    ids, t = wavefront.hit_ids(scene, o, d)
    ids = np.asarray(ids)
    assert ids[0] >= 0          # toward the cube
    assert ids[1] == -1         # away
    assert ids[2] == -1         # away
    assert np.isfinite(np.asarray(t)[0])


def test_wavefront_methods_agree():
    mesh = procgen.uv_sphere(10, 14)
    scene = mesh_mod.upload(flatten_models([mesh], pad_to=128))
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(-4, 4, (128, 3)).astype(np.float32) + 5)
    d = -o
    i1, t1 = wavefront.hit_ids(scene, o, d, method="dense")
    i2, t2 = wavefront.hit_ids(scene, o, d, method="bvh")
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_defocus_blur_changes_offfocus_only():
    """DoF: pinhole vs wide aperture — the image changes, stays finite, and
    a zero-aperture camera reproduces the pinhole exactly."""
    import dataclasses

    spheres = default_sphere_scene()
    lights = sphere_scene_lights()
    cfg = RenderConfig(max_depth=2, rr_bounces=0, spp=4)
    cam0 = CameraConfig(width=24, height=16, focus_dist=2.0)
    cam_dof = dataclasses.replace(cam0, defocus_angle=10.0)

    key = jax.random.key(1)
    img0 = pathtracer.render_spheres(spheres, lights, cam0, cfg, key)
    img_dof = pathtracer.render_spheres(spheres, lights, cam_dof, cfg, key)
    assert np.isfinite(np.asarray(img_dof)).all()
    assert np.abs(np.asarray(img_dof) - np.asarray(img0)).max() > 1e-3

    cam_zero = dataclasses.replace(cam0, defocus_angle=0.0)
    img_zero = pathtracer.render_spheres(spheres, lights, cam_zero, cfg, key)
    np.testing.assert_array_equal(np.asarray(img_zero), np.asarray(img0))


def test_atlas_sampling_bilinear():
    img0 = np.zeros((4, 4, 3), np.float32)
    img0[:, :, 0] = 1.0                      # red texture
    img1 = np.zeros((8, 8, 3), np.float32)
    img1[:, :, 1] = 1.0                      # green texture
    atlas = pack_atlas([img0, img1])
    a = jnp.asarray(atlas.image)
    r = jnp.asarray(atlas.rects)

    uv = jnp.asarray([[0.5, 0.5], [0.25, 0.75]], jnp.float32)
    red = sample_atlas(a, r, jnp.asarray([0, 0]), uv)
    np.testing.assert_allclose(np.asarray(red), [[1, 0, 0], [1, 0, 0]], atol=1e-6)
    green = sample_atlas(a, r, jnp.asarray([1, 1]), uv)
    np.testing.assert_allclose(np.asarray(green), [[0, 1, 0], [0, 1, 0]], atol=1e-6)


def test_textured_mesh_renders(tmp_path):
    """End-to-end: map_Kd texture -> atlas -> in-kernel albedo."""
    pytest.importorskip("PIL")
    from PIL import Image

    # A solid blue 8x8 texture on disk.
    tex_path = str(tmp_path / "blue.png")
    Image.fromarray(
        np.broadcast_to(np.asarray([20, 40, 230], np.uint8), (8, 8, 3)).copy()
    ).save(tex_path)

    mat = MaterialDef(diffuse=(1.0, 0.0, 0.0), specular=(0.3, 0.3, 0.3),
                      specular_ex=32.0, use_texture=True, texture_path=tex_path)
    mesh = procgen.uv_sphere(8, 12, radius=1.5, material=mat)

    atlas, tex_index = build_atlas_for_materials(mesh.materials)
    assert atlas is not None and tex_index[0] == 0

    flat = flatten_models([mesh])
    flat.mat_tex_index[:] = tex_index
    scene = mesh_mod.upload(flat, atlas=atlas.image, atlas_rects=atlas.rects)

    # Direct hit: albedo must come from the texture (blue-ish), not Kd (red).
    o = jnp.asarray([[0.0, 0.0, 5.0]], jnp.float32).T
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32).T
    rec = mesh_mod.mesh_hit_fn(scene, method="dense")(
        o, d, 1e-3, jnp.full((1,), jnp.inf)
    )
    alb = np.asarray(rec.mat.albedo)[:, 0]
    assert bool(np.asarray(rec.hit)[0])
    assert alb[2] > 0.5 and alb[0] < 0.1, f"expected textured blue, got {alb}"

    # And a full render works.
    cam = CameraConfig(width=16, height=12, origin=(0, 0, 5), look_at=(0, 0, 0))
    cfg = RenderConfig(max_depth=2, rr_bounces=0)
    img = pathtracer.render(
        mesh_mod.mesh_hit_fn(scene, method="dense"), model_scene_lights(),
        cam, cfg, jax.random.key(0),
    )
    assert np.isfinite(np.asarray(img)).all()


def test_textured_render_parity_dense_vs_bvh():
    """Texture fetch parity across traversal strategies (the bench's
    config9 path): a procedurally textured mesh with mip atlas + ray-cone
    LOD renders identically through the dense sweep and the BVH candidate
    search + refine — the atlas gathers sit outside the traversal, so hit
    parity must imply image parity (bindless-fetch analog,
    raytrace_utils.glsl:140-175)."""
    from srt_tpu.utils.atlas import pack_atlas

    mesh = procgen.uv_sphere(12, 16, radius=1.5)
    flat = flatten_models([mesh])
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64.0
    checker = ((np.floor(xx * 8) + np.floor(yy * 8)) % 2)
    img = np.stack([0.2 + 0.6 * checker, 0.3 + 0.5 * yy,
                    0.8 - 0.5 * xx], axis=-1).astype(np.float32)
    atlas = pack_atlas([img], mip_levels=4)

    def scene():
        s = mesh_mod.upload(
            flat, atlas=atlas.image, atlas_rects=atlas.rects,
            atlas_mip_rects=atlas.mip_rects, mip_lod_scale=10.0)
        return s.replace(
            mat_use_texture=jnp.ones_like(s.mat_use_texture),
            mat_tex_index=jnp.zeros_like(s.mat_tex_index))

    cam = CameraConfig(width=24, height=16, origin=(0, 0.5, 5),
                       look_at=(0, 0, 0))
    cfg = RenderConfig(max_depth=3, rr_bounces=0, ray_cones=True)
    imgs = {}
    for method in ("dense", "bvh"):
        imgs[method] = np.asarray(pathtracer.render(
            mesh_mod.mesh_hit_fn(scene(), method=method),
            model_scene_lights(), cam, cfg, jax.random.key(0)))
        assert np.isfinite(imgs[method]).all()
    np.testing.assert_allclose(imgs["bvh"], imgs["dense"],
                               rtol=1e-5, atol=1e-6)
    # The texture must actually be in the image (not the grey default Kd):
    # the checker makes albedo vary across pixels.
    assert imgs["dense"].std() > 1e-3


def test_union_scene_spheres_plus_mesh():
    """Heterogeneous scene: sphere in front of a cube — union picks the
    closest hit per ray (generalizes the reference's showModel switch)."""
    from srt_tpu.scene import Materials, Spheres, make_materials

    sph = Spheres(
        center=jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32),
        radius=jnp.asarray([0.5], jnp.float32),
        materials=make_materials([((1, 0, 0), (0.5,) * 3, 0.2, 0.1, True)]),
    )
    cube_scene = mesh_mod.upload(flatten_models([procgen.cube(size=2.0)]))
    union = pathtracer.union_hit_fn(
        pathtracer.spheres_hit_fn(sph),
        mesh_mod.mesh_hit_fn(cube_scene, method="dense"),
    )
    o = jnp.asarray([[0, 0, 5], [0.9, 0.9, 5]], jnp.float32).T
    d = jnp.asarray([[0, 0, -1], [0, 0, -1]], jnp.float32).T
    rec = union(o, d, 1e-3, jnp.full((2,), jnp.inf))
    hits = np.asarray(rec.hit)
    t = np.asarray(rec.t)
    assert hits.all()
    # Ray 0 hits the sphere (t = 5 - 2 - 0.5 = 2.5), closer than cube (4).
    np.testing.assert_allclose(t[0], 2.5, rtol=1e-5)
    # Ray 1 misses the sphere, hits the cube front face at z=1 -> t=4.
    np.testing.assert_allclose(t[1], 4.0, rtol=1e-5)
    # Material of ray 0 comes from the sphere (red albedo).
    np.testing.assert_allclose(np.asarray(rec.mat.albedo)[:, 0], [1, 0, 0],
                               atol=1e-6)

    # And it renders through the integrator.
    cam = CameraConfig(width=12, height=8, origin=(0, 0, 5), look_at=(0, 0, 0))
    img = pathtracer.render(union, sphere_scene_lights(), cam,
                            RenderConfig(max_depth=2, rr_bounces=0),
                            jax.random.key(0))
    assert np.isfinite(np.asarray(img)).all()


def test_mip_chain_and_trilinear_sampling():
    """Mip parity with the reference's glGenerateMipmap +
    GL_LINEAR_MIPMAP_LINEAR sampler (gpu_texture.h:39-53): box-filtered
    chain, per-level rects, trilinear blend between levels."""
    import numpy as np

    from srt_tpu.utils.atlas import build_mip_chain

    # 4x4 checkerboard: level 1 is the 2x2 average = flat 0.5.
    img = np.zeros((4, 4, 3), np.float32)
    img[::2, 1::2] = 1.0
    img[1::2, ::2] = 1.0
    chain = build_mip_chain(img, 3)
    assert [c.shape[:2] for c in chain] == [(4, 4), (2, 2), (1, 1)]
    np.testing.assert_allclose(chain[1], 0.5)
    np.testing.assert_allclose(chain[2], 0.5)

    solid = np.full((4, 4, 3), 0.25, np.float32)
    atlas = pack_atlas([img, solid], mip_levels=3)
    assert atlas.mip_rects.shape == (2, 3, 4)
    a = jnp.asarray(atlas.image)
    r = jnp.asarray(atlas.rects)
    mr = jnp.asarray(atlas.mip_rects)
    uv = jnp.asarray([[0.5, 0.5]] * 3, jnp.float32)
    idx = jnp.asarray([0, 0, 0])

    # lod 0 == base bilinear; lod 1 == flat grey; lod 0.5 blends halfway.
    base = sample_atlas(a, r, idx, uv)
    l0 = sample_atlas(a, r, idx, uv, mip_rects=mr, lod=jnp.zeros(3))
    l1 = sample_atlas(a, r, idx, uv, mip_rects=mr, lod=jnp.ones(3))
    lh = sample_atlas(a, r, idx, uv, mip_rects=mr, lod=jnp.full(3, 0.5))
    np.testing.assert_allclose(np.asarray(l0), np.asarray(base), atol=1e-6)
    np.testing.assert_allclose(np.asarray(l1), 0.5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(lh),
                               0.5 * (np.asarray(base) + 0.5), atol=1e-6)
    # lod clamps to the last level.
    l9 = sample_atlas(a, r, idx, uv, mip_rects=mr, lod=jnp.full(3, 9.0))
    np.testing.assert_allclose(np.asarray(l9), 0.5, atol=1e-6)


def test_mip_lod_in_mesh_render_changes_minified_albedo():
    """A textured mesh scene with mip_lod_scale uses distance-based LOD;
    far hits sample coarser (averaged) levels."""
    import numpy as np

    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.utils import procgen
    from srt_tpu.utils.flatten import flatten_models

    img = np.zeros((8, 8, 3), np.float32)
    img[::2, 1::2] = 1.0
    img[1::2, ::2] = 1.0
    atlas = pack_atlas([img], mip_levels=4)

    mesh = procgen.uv_sphere(8, 12, radius=1.0)  # real spherical UVs
    flat = flatten_models([mesh])
    flat.mat_use_texture[:] = True
    flat.mat_tex_index[:] = 0
    kw = dict(atlas=atlas.image, atlas_rects=atlas.rects,
              atlas_mip_rects=atlas.mip_rects)
    near = mesh_mod.upload(flat, mip_lod_scale=0.0, **kw)
    far = mesh_mod.upload(flat, mip_lod_scale=100.0, **kw)

    xs = np.linspace(-0.6, 0.6, 16, dtype=np.float32)
    o = jnp.asarray(np.stack([xs, xs * 0.7, np.full(16, 5.0, np.float32)]))
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 16, jnp.float32).T
    tm = jnp.full((16,), jnp.inf)
    rec_near = mesh_mod.mesh_hit_fn(near)(o, d, 1e-3, tm)
    rec_far = mesh_mod.mesh_hit_fn(far)(o, d, 1e-3, tm)
    assert bool(rec_near.hit.all()) and bool(rec_far.hit.all())
    # Huge lod scale drives sampling to the 1x1 level: flat 0.5 albedo.
    np.testing.assert_allclose(np.asarray(rec_far.mat.albedo), 0.5, atol=1e-5)
    # Base level across the checker face is not flat everywhere.
    assert np.abs(np.asarray(rec_near.mat.albedo) - 0.5).max() > 0.05


def test_legacy_brdf_tail():
    """Legacy sampler set (brdf.glsl:290-386) parity checks: cosine pdf,
    hemisphere-correct sample directions, per-lobe evaluator selection."""
    import numpy as np

    from srt_tpu.ops import brdf, vec
    from srt_tpu.scene import Materials

    n = 256
    rng = np.random.default_rng(4)
    normal = vec.normalize(jnp.asarray(rng.normal(size=(3, n)), jnp.float32))
    in_dir = vec.normalize(jnp.asarray(rng.normal(size=(3, n)), jnp.float32))
    mat = Materials(
        albedo=jnp.asarray(rng.uniform(0.2, 0.9, (3, n)), jnp.float32),
        specular=jnp.asarray(rng.uniform(0.0, 0.2, (3, n)), jnp.float32),
        roughness=jnp.asarray(rng.uniform(0.1, 0.9, n), jnp.float32),
        metalness=jnp.full((n,), 0.1, jnp.float32),
        use_spec=jnp.ones((n,), bool),
    )
    u = lambda s: jnp.asarray(np.random.default_rng(s).uniform(size=n),
                              jnp.float32)
    d, pdf, is_diff = brdf.legacy_sample_next_ray(
        jnp.zeros((3, n)), normal, in_dir, mat, u(1), u(2), u(3))

    # Diffuse pdf is exactly cos(theta)/pi of the sampled direction.
    cos = np.asarray(jnp.sum(normal * d, axis=0))
    isd = np.asarray(is_diff)
    np.testing.assert_allclose(np.asarray(pdf)[isd],
                               np.maximum(cos[isd], 0.0) / np.pi,
                               rtol=1e-5, atol=1e-6)
    # Diffuse samples lie in the normal hemisphere.
    assert (cos[isd] > 0).all()
    assert np.isfinite(np.asarray(pdf)).all() and (np.asarray(pdf) >= 0).all()

    # Per-lobe evaluator: diffuse lobe returns NdotL * albedo / pi.
    val = np.asarray(brdf.legacy_brdf(normal, in_dir, d, mat, is_diff))
    expect_diff = np.asarray(mat.albedo) * np.maximum(cos, 0.0) / np.pi
    np.testing.assert_allclose(val[:, isd], expect_diff[:, isd],
                               rtol=1e-5, atol=1e-6)
    # Specular lobe: finite, nonnegative, and NOT the diffuse value.
    sp = ~isd
    assert np.isfinite(val[:, sp]).all() and (val[:, sp] >= 0).all()


def test_emissive_mesh_materials(tmp_path):
    """Ke materials emit: the reference parses Ke and drops it
    (model_loader.cpp:240-273); here emitters light the image and are
    differentiable scene parameters."""
    import numpy as np

    from srt_tpu.scene import Lights

    # MTL parse: Ke lands on MaterialDef.emissive.
    mtl = tmp_path / "glow.mtl"
    mtl.write_text("newmtl lamp\nKd 0.1 0.1 0.1\nKe 2.0 1.0 0.5\n")
    obj = tmp_path / "glow.obj"
    obj.write_text(
        f"mtllib {mtl.name}\nusemtl lamp\n"
        "v -1 -1 0\nv 1 -1 0\nv 0 1 0\nf 1 2 3\n")
    from srt_tpu.utils.obj_loader import load_object
    mesh = load_object(str(obj), use_native="never")
    assert mesh.materials[0].emissive == (2.0, 1.0, 0.5)

    scene = mesh_mod.upload(flatten_models([mesh]))
    # No lights, black sky: any radiance must come from emission.
    dark = Lights(position=jnp.zeros((1, 3)), color=jnp.zeros((1, 3)),
                  intensity=jnp.zeros((1,)))
    cam = CameraConfig(width=16, height=12, origin=(0, 0, 3),
                       look_at=(0, 0, 0))
    cfg = RenderConfig(max_depth=2, rr_bounces=0,
                       sky_color=(0.0, 0.0, 0.0), sky_always=False)
    img = pathtracer.render(mesh_mod.mesh_hit_fn(scene, method="dense"),
                            dark, cam, cfg, jax.random.key(0))
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert img.max() > 0.5                 # the emitter shows up
    # Emission color ratio survives (R:G = 2:1 on direct-hit pixels).
    direct = img.reshape(-1, 3)[img.reshape(-1, 3)[:, 0] > 1.0]
    assert direct.size > 0
    np.testing.assert_allclose(direct[:, 0] / direct[:, 1], 2.0, rtol=1e-4)

    # Differentiable: d(mean)/d(Ke) is finite and positive for hit pixels.
    def loss(ke):
        s = scene.replace(mat_emissive=ke)
        im = pathtracer.render(mesh_mod.mesh_hit_fn(s, method="dense"),
                               dark, cam, cfg, jax.random.key(0))
        return jnp.mean(im)

    g = jax.grad(loss)(scene.mat_emissive)
    assert np.isfinite(np.asarray(g)).all()
    assert float(np.asarray(g).max()) > 0


def test_cone_lod_uses_footprint():
    """Ray-cone mip selection (RenderConfig.ray_cones): the SAME hit
    distance samples the base level for a zero-width cone and the 1x1
    level for a huge one — footprint, not distance, drives the LOD."""
    import numpy as np

    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.utils import procgen
    from srt_tpu.utils.flatten import flatten_models

    img = np.zeros((8, 8, 3), np.float32)
    img[::2, 1::2] = 1.0
    img[1::2, ::2] = 1.0
    atlas = pack_atlas([img], mip_levels=4)

    mesh = procgen.uv_sphere(8, 12, radius=1.0)
    flat = flatten_models([mesh])
    flat.mat_use_texture[:] = True
    flat.mat_tex_index[:] = 0
    scene = mesh_mod.upload(flat, mip_lod_scale=4.0, atlas=atlas.image,
                            atlas_rects=atlas.rects,
                            atlas_mip_rects=atlas.mip_rects)

    xs = np.linspace(-0.6, 0.6, 16, dtype=np.float32)
    o = jnp.asarray(np.stack([xs, xs * 0.7, np.full(16, 5.0, np.float32)]))
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 16, jnp.float32).T
    tm = jnp.full((16,), jnp.inf)
    hit = mesh_mod.mesh_hit_fn(scene)
    zeros = jnp.zeros((16,), jnp.float32)
    rec_sharp = hit(o, d, 1e-3, tm, cone=(zeros, zeros))
    rec_wide = hit(o, d, 1e-3, tm, cone=(jnp.full((16,), 100.0), zeros))
    assert bool(rec_sharp.hit.all())
    # Huge footprint -> 1x1 mip -> flat 0.5 albedo.
    np.testing.assert_allclose(np.asarray(rec_wide.mat.albedo), 0.5,
                               atol=1e-5)
    # Zero cone -> base level, not flat.
    assert np.abs(np.asarray(rec_sharp.mat.albedo) - 0.5).max() > 0.05


def test_ray_cones_through_integrator():
    """cfg.ray_cones=True: the integrator carries (width, spread) through
    bounces and secondary hits sample measurably coarser mips than with
    the cones disabled."""
    import numpy as np

    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.models import mesh as mesh_mod
    from srt_tpu.models import pathtracer
    from srt_tpu.scene import model_scene_lights
    from srt_tpu.utils import procgen
    from srt_tpu.utils.flatten import flatten_models

    img = np.zeros((8, 8, 3), np.float32)
    img[::2, 1::2] = 1.0
    img[1::2, ::2] = 1.0
    atlas = pack_atlas([img], mip_levels=4)
    mesh = procgen.uv_sphere(8, 12, radius=1.0)
    flat = flatten_models([mesh])
    flat.mat_use_texture[:] = True
    flat.mat_tex_index[:] = 0
    scene = mesh_mod.upload(flat, mip_lod_scale=8.0, atlas=atlas.image,
                            atlas_rects=atlas.rects,
                            atlas_mip_rects=atlas.mip_rects)
    lights = model_scene_lights()
    cam = CameraConfig(width=24, height=16, origin=(0.0, 0.5, 4.0),
                       look_at=(0.0, 0.0, 0.0))
    hit = mesh_mod.mesh_hit_fn(scene)
    key = jax.random.key(4)

    img_off = pathtracer.render(
        hit, lights, cam, RenderConfig(max_depth=3, rr_bounces=0), key)
    img_on = pathtracer.render(
        hit, lights, cam,
        RenderConfig(max_depth=3, rr_bounces=0, ray_cones=True), key)
    a, b = np.asarray(img_off), np.asarray(img_on)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    # Same RNG decisions, different albedo filtering -> images differ,
    # but only moderately (it is a filtering change, not a light change).
    diff = np.abs(a - b)
    assert diff.max() > 1e-4
    assert diff.mean() < 0.2


def test_slotblock_rows_at_matches_full():
    """Gather-free slot evaluation (ops/rng.SlotBlock.rows_at) must be
    bit-equal to materializing the block and gathering rows — it encodes
    jax's partitionable-threefry counter layout, so any jax-internal
    change must be caught here, not as silently different renders."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from srt_tpu.ops.rng import KeyStream

    n, k = 4096, 12
    s1 = KeyStream(jax.random.key(9), n)
    s2 = KeyStream(jax.random.key(9), n)
    full = s1.take(k)
    blk = s2.take_block(k)
    cols = jnp.asarray(np.random.default_rng(1).permutation(n)[:1000])
    np.testing.assert_array_equal(
        np.asarray(blk.rows_at(0, k, cols)), np.asarray(full[:, cols]))
    np.testing.assert_array_equal(
        np.asarray(blk.rows_at(3, 7, cols)), np.asarray(full[3:7, cols]))
    # Counter advance must match take()'s.
    np.testing.assert_array_equal(np.asarray(s1.take(2)),
                                  np.asarray(s2.take(2)))


def test_quad_packed_atlas_matches_taps():
    """The quad-packed single-gather bilinear path (r5 texture fast path)
    must be BIT-equal to the four-tap gather path, including repeat-wrap
    edges and trilinear mip blending."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from srt_tpu.ops.texture import sample_atlas
    from srt_tpu.utils.atlas import build_quad_table, pack_atlas

    rng = np.random.default_rng(0)
    imgs = [rng.uniform(size=(64, 64, 3)).astype(np.float32),
            rng.uniform(size=(32, 48, 3)).astype(np.float32)]
    atlas = pack_atlas(imgs, mip_levels=4)
    quad = jnp.asarray(build_quad_table(atlas.image, atlas.rects,
                                        atlas.mip_rects))
    n = 4096
    uv = jnp.asarray(rng.uniform(-0.2, 1.2, (n, 2)).astype(np.float32))
    ti = jnp.asarray(rng.integers(0, 2, n).astype(np.int32))
    lod = jnp.asarray(rng.uniform(0, 3.5, n).astype(np.float32))
    img = jnp.asarray(atlas.image)
    rects = jnp.asarray(atlas.rects)
    mips = jnp.asarray(atlas.mip_rects)
    for kw in ({}, {"mip_rects": mips, "lod": lod}):
        a = sample_atlas(img, rects, ti, uv, **kw)
        b = sample_atlas(img, rects, ti, uv, quad=quad, **kw)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
