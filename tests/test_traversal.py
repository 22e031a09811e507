"""Traversal strategies: the "bvh" walk against the dense sweep, the GPU
kernel's packed tables, BVH node refit, and the platform's choice of
strategy.  Tests marked ``gpu`` run the kernel itself and skip without a
card (see README, "Tests and the GPU")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srt_tpu.models import mesh as mesh_mod
from srt_tpu.ops import traversal_cuda
from srt_tpu.utils import procgen
from srt_tpu.utils.flatten import flatten_models

T_MIN = 1e-3


def _two_models():
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = (0.8, -0.3, 0.5)         # world->model translation
    rot = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.6), np.sin(0.6)
    rot[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    return flatten_models([procgen.uv_sphere(8, 12, radius=1.2),
                           procgen.rubik_grid(spacing=0.6, size=0.5)],
                          frames=[shift, rot])


SCENES = {
    "sphere": lambda: flatten_models([procgen.uv_sphere(12, 18, radius=2.0)]),
    "cube_padded": lambda: flatten_models([procgen.cube()], pad_to=128),
    "rubik": lambda: flatten_models([procgen.rubik_grid()]),
    "leaf4": lambda: flatten_models([procgen.uv_sphere(9, 13)], leaf_size=4),
}


def _rays(n=384, seed=0, spread=3.5):
    """Rays from a shell around the scene toward jittered targets, plus
    rays that start inside it (bounce-like)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = spread * o / np.linalg.norm(o, axis=1, keepdims=True)
    o[: n // 4] *= 0.2
    d = rng.uniform(-0.8, 0.8, (n, 3)) - o
    d[: n // 4] = rng.normal(size=(n // 4, 3))
    return (jnp.asarray(o.T, jnp.float32), jnp.asarray(d.T, jnp.float32))


def _closest(scene, method, o, d, t_max=jnp.inf):
    h = jax.jit(lambda o, d: mesh_mod.mesh_hit_fn(scene, method=method)(
        o, d, T_MIN, t_max))(o, d)
    return np.asarray(h.tri), np.asarray(h.t), np.asarray(h.normal)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bvh_matches_dense(name):
    scene = mesh_mod.upload(SCENES[name]())
    o, d = _rays()
    i_b, t_b, n_b = _closest(scene, "bvh", o, d)
    i_d, t_d, n_d = _closest(scene, "dense", o, d)
    assert (i_d >= 0).sum() > 50
    np.testing.assert_array_equal(i_b, i_d)
    hit = i_d >= 0
    np.testing.assert_allclose(t_b[hit], t_d[hit], rtol=1e-6)
    np.testing.assert_allclose(n_b, n_d, atol=1e-6)


@pytest.mark.parametrize("method", ["bvh", "dense"])
def test_any_hit_segments(method):
    """Shadow-style segments (t_min, t_max): occlusion equals "the
    closest hit beyond t_min lies before t_max", from the dense sweep."""
    scene = mesh_mod.upload(SCENES["rubik"]())
    o, d = _rays(seed=1)
    i_c, t_c, _ = _closest(scene, "dense", o, d)
    t_max = jnp.asarray(np.where(np.arange(o.shape[1]) % 2 == 0,
                                 np.where(i_c >= 0, t_c * 0.999, 2.0),
                                 np.where(i_c >= 0, t_c * 1.001, 50.0)),
                        jnp.float32)
    occ = jax.jit(lambda o, d, tm: mesh_mod.mesh_hit_fn(scene, method)(
        o, d, T_MIN, tm, any_hit=True).hit)(o, d, t_max)
    expect = (i_c >= 0) & (t_c < np.asarray(t_max))
    np.testing.assert_array_equal(np.asarray(occ), expect)
    assert 10 < expect.sum() < expect.size - 10


def test_multi_model_frames_bvh_matches_dense():
    scene = mesh_mod.upload(_two_models())
    assert scene.num_models == 2
    o, d = _rays(seed=2)
    i_b, t_b, _ = _closest(scene, "bvh", o, d)
    i_d, t_d, _ = _closest(scene, "dense", o, d)
    np.testing.assert_array_equal(i_b, i_d)
    first2 = scene.model_first_tri[1]
    assert ((i_d >= 0) & (i_d < first2)).sum() > 10
    assert (i_d >= first2).sum() > 10


def _host_bounds(flat, v0, v1, v2):
    """Node bounds rebuilt on the host over the uploaded topology."""
    lo_t = np.minimum(np.minimum(v0, v1), v2)
    hi_t = np.maximum(np.maximum(v0, v1), v2)
    n = flat.node_first.shape[0]
    lo, hi = np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32)
    for ni in range(n - 1, -1, -1):       # children follow their parent
        f, c = int(flat.node_first[ni]), int(flat.node_count[ni])
        if c:
            lo[ni], hi[ni] = lo_t[f:f + c].min(0), hi_t[f:f + c].max(0)
        else:
            lo[ni] = np.minimum(lo[f], lo[f + 1])
            hi[ni] = np.maximum(hi[f], hi[f + 1])
    return lo, hi


def _moved(scene, seed=3, scale=0.15):
    rng = np.random.default_rng(seed)
    pos = scene.positions + jnp.asarray(
        rng.normal(scale=scale, size=scene.positions.shape), jnp.float32)
    return jax.jit(lambda s, p: mesh_mod.refit_accel(
        mesh_mod.with_positions(s, p)))(scene, pos)


def test_refit_bounds_equal_host_rebuild():
    flat = _two_models()
    moved = _moved(mesh_mod.upload(flat))
    v0, v1, v2 = (np.asarray(x) for x in
                  (moved.tri_v0, moved.tri_v1, moved.tri_v2))
    lo, hi = _host_bounds(flat, v0, v1, v2)
    np.testing.assert_array_equal(np.asarray(moved.node_min), lo)
    np.testing.assert_array_equal(np.asarray(moved.node_max), hi)


def test_refit_hits_match_dense_after_vertex_move():
    scene = mesh_mod.upload(SCENES["sphere"]())
    moved = _moved(scene, scale=0.05)
    o, d = _rays(seed=4)
    i_b, t_b, _ = _closest(moved, "bvh", o, d)
    i_d, t_d, _ = _closest(moved, "dense", o, d)
    np.testing.assert_array_equal(i_b, i_d)
    # Stale bounds would lose hits: the unrefit walk disagrees somewhere.
    stale = mesh_mod.with_positions(scene, moved.positions)
    i_s, _, _ = _closest(stale, "bvh", o, d)
    assert (i_s != i_d).any()


@pytest.mark.parametrize("name", ["cube_padded", "rubik"])
def test_packed_tables_decode_to_bvh(name):
    flat = SCENES[name]()
    scene = mesh_mod.upload(flat)
    nodes = np.asarray(scene.bvh_nodes)
    tris = np.asarray(scene.bvh_tris)
    assert nodes.dtype == np.float32 and tris.dtype == np.float32
    assert nodes.shape == (flat.node_first.shape[0],
                           traversal_cuda.NODE_WORDS)
    assert tris.shape == (flat.tri_v0.shape[0], traversal_cuda.TRI_WORDS)
    assert nodes.strides[0] == 32 and tris.strides[0] == 48   # float4 rows
    np.testing.assert_array_equal(nodes[:, 0:3], flat.node_min)
    np.testing.assert_array_equal(nodes[:, 4:7], flat.node_max)
    np.testing.assert_array_equal(nodes[:, 3].view(np.int32),
                                  flat.node_first)
    np.testing.assert_array_equal(nodes[:, 7].view(np.int32),
                                  flat.node_count)
    np.testing.assert_array_equal(tris[:, 0:3], flat.tri_v0)
    np.testing.assert_array_equal(tris[:, 4:7], flat.tri_v1 - flat.tri_v0)
    np.testing.assert_array_equal(tris[:, 8:11], flat.tri_v2 - flat.tri_v0)
    np.testing.assert_array_equal(tris[:, [3, 7, 11]], 0.0)
    # Leaves index triangles in BVH order and never the padding rows.
    leaf = flat.node_count > 0
    last = flat.node_first[leaf] + flat.node_count[leaf]
    assert last.max() <= flat.model_tri_count.sum()


@pytest.mark.parametrize("platform,expect", [
    ("gpu", mesh_mod.GPU_METHOD), ("cpu", "dense"), ("METAL", None)])
def test_default_method_per_platform(monkeypatch, platform, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if expect is None:
        with pytest.raises(RuntimeError, match="no traversal strategy"):
            mesh_mod.default_method()
    else:
        assert mesh_mod.default_method() == expect


def test_cuda_strategy_raises_off_gpu():
    scene = mesh_mod.upload(SCENES["cube_padded"]())
    with pytest.raises(RuntimeError, match="needs a GPU"):
        mesh_mod.mesh_hit_fn(scene, method="cuda")
    o, d = _rays(n=8)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        traversal_cuda.traverse(scene.bvh_nodes, scene.bvh_tris, o, d,
                                jnp.inf, root=0, stack_depth=8)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
def test_cuda_kernel_matches_dense(gpu, name):
    scene = mesh_mod.upload(SCENES[name]())
    o, d = _rays()
    i_k, t_k, _ = _closest(scene, "cuda", o, d)
    i_d, t_d, _ = _closest(scene, "dense", o, d)
    np.testing.assert_array_equal(i_k, i_d)
    np.testing.assert_allclose(t_k[i_d >= 0], t_d[i_d >= 0], rtol=1e-6)


@pytest.mark.gpu
def test_cuda_kernel_multi_model_and_any_hit(gpu):
    scene = mesh_mod.upload(_two_models())
    o, d = _rays(seed=5)
    i_k, _, _ = _closest(scene, "cuda", o, d)
    i_d, t_d, _ = _closest(scene, "dense", o, d)
    np.testing.assert_array_equal(i_k, i_d)
    t_max = jnp.asarray(np.where(i_d >= 0, t_d * 0.999, 2.0), jnp.float32)
    occ = mesh_mod.mesh_hit_fn(scene, "cuda")(o, d, T_MIN, t_max,
                                              any_hit=True).hit
    ref = mesh_mod.mesh_hit_fn(scene, "dense")(o, d, T_MIN, t_max,
                                               any_hit=True).hit
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))


@pytest.mark.gpu
def test_cuda_kernel_gradients_match_dense(gpu):
    from srt_tpu.config import CameraConfig, RenderConfig
    from srt_tpu.models import pathtracer
    from srt_tpu.scene import model_scene_lights

    scene = mesh_mod.upload(SCENES["sphere"]())
    cam = CameraConfig(width=16, height=12, origin=(0.0, 1.0, 5.0),
                       look_at=(0.0, 0.0, 0.0))
    cfg = RenderConfig(max_depth=2, rr_bounces=0)

    def loss(positions, method):
        s = mesh_mod.refit_accel(mesh_mod.with_positions(scene, positions))
        img = pathtracer.render(mesh_mod.mesh_hit_fn(s, method=method),
                                model_scene_lights(), cam, cfg,
                                jax.random.key(0))
        return jnp.mean(img)

    g = {m: np.asarray(jax.grad(loss)(scene.positions, m))
         for m in ("cuda", "dense")}
    assert np.abs(g["cuda"]).max() > 0
    np.testing.assert_allclose(g["cuda"], g["dense"], rtol=1e-4,
                               atol=1e-6 * np.abs(g["dense"]).max())
