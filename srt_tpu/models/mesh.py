"""Triangle-mesh scenes: device pytree, traversal strategies, shading hookup.

The device-side counterpart of the reference's model path: ``CheckHit``'s
per-model frame transform + BVH traversal (raytrace_compute.glsl:143-161 ->
``Intersects``, ray_intersects.glsl:99-133) and the OBJ-material conversion
``TriangleToSupportedMat`` (raytrace_utils.glsl:140-175).

Traversal strategies over the flattened node/triangle arrays:

* ``"dense"`` — every ray against every triangle, ``[tile, T]`` broadcast
  Moller-Trumbore.  No divergence, no gather; the CPU default and the
  correctness baseline for everything.
* ``"bvh"``   — classic per-ray stack traversal (``lax.while_loop`` with a
  fixed-size stack, vmapped).  Matches the reference algorithm one-to-one
  in plain XLA; the semantic reference for the GPU kernel.
* ``"cuda"``  — the GPU kernel (ops/traversal_cuda.py): the same per-ray
  stack walk, one thread per ray, nearer child first.

``default_method`` picks one from the platform.  All strategies return the
same hits up to exact-t ties (tested).  ``"bvh"`` and ``"cuda"`` are
candidate searches on ``stop_gradient``'d operands; the winner's exact
(t, u, v) is re-derived by a differentiable Moller-Trumbore refine, so the
whole thing is differentiable w.r.t. triangle vertices, frames, and
material tables under every strategy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from srt_tpu.models.pathtracer import Hit, HitFn
from srt_tpu.ops import intersect
from srt_tpu.ops import traversal_cuda
from srt_tpu.ops import vec
from srt_tpu.scene import Materials
from srt_tpu.utils.flatten import FlatScene

INF = jnp.float32(jnp.inf)
MISS = jnp.int32(-1)
HIGHEST = jax.lax.Precision.HIGHEST

# ``TriangleToSupportedMat`` constants (raytrace_utils.glsl:169-173).
MESH_METALNESS = 0.1
ROUGHNESS_EPS = 1e-7

# Strategies that return a candidate (t, triangle) and leave the exact
# (t, u, v) to the shared refine in ``mesh_hit_fn``.
CANDIDATE_METHODS = ("bvh", "cuda")
# The GPU strategy, chosen by measurement on an H100 (PERF.md,
# "Traversal on the H100").
GPU_METHOD = "cuda"


def default_method() -> str:
    """The traversal strategy for the platform JAX runs on: the GPU
    kernel on a GPU, the dense sweep on the CPU.  Any other platform
    raises — there is no silent fallback."""
    platform = jax.default_backend()
    if platform == "gpu":
        return GPU_METHOD
    if platform == "cpu":
        return "dense"
    raise RuntimeError(f"no traversal strategy for platform {platform!r}")


def _static(default):
    return dataclasses.field(default=default, metadata={"static": True})


def _pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree: fields made with
    ``_static`` are trace-time metadata, the rest are leaves."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])


@_pytree_dataclass
class MeshScene:
    """Device-resident flattened multi-model scene.

    Array fields are traced (differentiable); ``static`` fields are python
    metadata fixed at trace time (model directory, sizes, stack depth).
    """

    frames: jnp.ndarray       # [B, 4, 4] world->model (differentiable pose)
    node_min: jnp.ndarray     # [Nn, 3]
    node_max: jnp.ndarray     # [Nn, 3]
    node_first: jnp.ndarray   # [Nn] int32
    node_count: jnp.ndarray   # [Nn] int32
    tri_v0: jnp.ndarray       # [T, 3] model-space corners
    tri_v1: jnp.ndarray
    tri_v2: jnp.ndarray
    uv0: jnp.ndarray          # [T, 2]
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    tri_mat: jnp.ndarray      # [T] int32
    tri_n0: jnp.ndarray       # [T, 3] shading normals (zero rows fall
    tri_n1: jnp.ndarray       #        back to the geometric normal)
    tri_n2: jnp.ndarray
    mat_diffuse: jnp.ndarray  # [M, 3]
    mat_specular: jnp.ndarray  # [M, 3]
    mat_emissive: jnp.ndarray  # [M, 3] (Ke; zero = non-emitter)
    mat_specular_ex: jnp.ndarray  # [M]
    mat_use_texture: jnp.ndarray  # [M] bool
    mat_tex_index: jnp.ndarray    # [M] int32
    # GPU kernel tables (ops/traversal_cuda.pack_tables): 32-byte node
    # records and 48-byte triangle records in BVH order.
    bvh_nodes: jnp.ndarray     # [Nn, 8] f32
    bvh_tris: jnp.ndarray      # [T, 12] f32
    # Node-refit topology (host-precomputed, see ``refit_accel``): the
    # leaf owning each triangle (Nn for padding triangles), and internal
    # nodes ordered deepest level first.
    tri_leaf: jnp.ndarray        # [T] int32
    refit_internal: jnp.ndarray  # [Ni] int32
    atlas: Optional[jnp.ndarray] = None  # [H, W, 3] texture atlas or None
    atlas_rects: Optional[jnp.ndarray] = None  # [K, 4] (x, y, w, h) in texels
    atlas_mip_rects: Optional[jnp.ndarray] = None  # [K, L, 4] mip chain rects
    # Quad-packed atlas [H*W, 12] (utils/atlas.build_quad_table): one
    # packed row gather per bilinear tap instead of four 2D gathers —
    # forward-render fast path; None when differentiating w.r.t. texels.
    atlas_quad: Optional[jnp.ndarray] = None
    # Shared-vertex view for geometry optimization: tri_v0/v1/v2 above are
    # the pre-gathered per-corner duplicates (model_loader.cpp:296-331);
    # ``with_positions`` re-derives them from this buffer so vertex
    # gradients scatter-add back to shared vertices via the gather VJP.
    tri_vidx: Optional[jnp.ndarray] = None   # [T, 3] int32 into positions
    positions: Optional[jnp.ndarray] = None  # [V, 3]
    # Edge adjacency (global triangle ids, -1 = boundary/padding): the
    # topology the mesh silhouette gradients walk
    # (models/edge_aware_mesh.py).
    tri_adj: Optional[jnp.ndarray] = None    # [T, 3] int32

    # Distance-based mip LOD: lod = log2(hit_t * mip_lod_scale), clamped to
    # the chain; 0 disables (base level only).  A path tracer has no screen
    # derivatives, so this is the standard distance heuristic — set scale
    # ~ texels-per-world-unit / viewport-rays-per-world-unit for the scene.
    mip_lod_scale: float = _static(0.0)
    model_first_node: tuple = _static((0,))
    model_first_tri: tuple = _static((0,))
    model_tri_count: tuple = _static((0,))
    model_padded_tri_count: tuple = _static((0,))
    num_triangles: int = _static(0)
    stack_depth: int = _static(34)
    max_leaf: int = _static(2)
    # Sizes of the levels of ``refit_internal``, deepest first.
    refit_level_sizes: tuple = _static(())

    @property
    def num_models(self) -> int:
        return len(self.model_first_node)


def _refit_topology(scene: FlatScene):
    """Host precompute for ``refit_accel``: (tri_leaf [T], internal nodes
    deepest level first [Ni], level sizes).  Depth is per model (from its
    root); models are independent, so one level list serves them all."""
    n_nodes = scene.node_first.shape[0]
    n_tris = scene.tri_v0.shape[0]
    first = scene.node_first.astype(np.int64)
    count = scene.node_count.astype(np.int64)
    tri_leaf = np.full(n_tris, n_nodes, np.int32)
    leaves = np.nonzero(count > 0)[0]
    offsets = np.arange(count[leaves].sum()) - np.repeat(
        np.cumsum(count[leaves]) - count[leaves], count[leaves])
    tri_leaf[np.repeat(first[leaves], count[leaves]) + offsets] = np.repeat(
        leaves, count[leaves])
    depth = np.full(n_nodes, -1, np.int64)
    depth[np.asarray(scene.model_first_node, np.int64)] = 0
    for ni in range(n_nodes):       # children always follow their parent
        if count[ni] == 0:
            depth[first[ni]] = depth[first[ni] + 1] = depth[ni] + 1
    internal = np.nonzero(count == 0)[0]
    order = internal[np.argsort(-depth[internal], kind="stable")]
    sizes = np.unique(-depth[order], return_counts=True)[1]
    return tri_leaf, order.astype(np.int32), tuple(int(x) for x in sizes)


def upload(scene: FlatScene, atlas=None, atlas_rects=None,
           atlas_mip_rects=None, mip_lod_scale: float = 0.0,
           quad_pack: bool = True) -> MeshScene:
    """Host FlatScene -> device MeshScene (the ``glBufferData`` moment,
    gpu_loader.cpp:142-182; here a plain pytree of jnp arrays), with the
    GPU kernel's packed tables and the node-refit topology."""
    # Quad-packed atlas (r5): the forward texture fast path; skip with
    # quad_pack=False when the caller will differentiate w.r.t. texels
    # (the quad table is a host-built copy, not a traced view).
    atlas_quad = None
    if quad_pack and atlas is not None and atlas_rects is not None:
        from srt_tpu.utils.atlas import build_quad_table
        atlas_quad = jnp.asarray(build_quad_table(
            np.asarray(atlas), np.asarray(atlas_rects),
            None if atlas_mip_rects is None
            else np.asarray(atlas_mip_rects)))

    t_total = scene.tri_v0.shape[0]
    firsts = [int(x) for x in scene.model_first_tri]
    padded_counts = tuple(
        (firsts[i + 1] if i + 1 < len(firsts) else t_total) - firsts[i]
        for i in range(len(firsts))
    )
    bvh_nodes, bvh_tris = traversal_cuda.pack_tables(
        scene.node_min, scene.node_max, scene.node_first, scene.node_count,
        scene.tri_v0, scene.tri_v1, scene.tri_v2)
    tri_leaf, refit_internal, level_sizes = _refit_topology(scene)

    return MeshScene(
        frames=jnp.asarray(scene.frames),
        node_min=jnp.asarray(scene.node_min),
        node_max=jnp.asarray(scene.node_max),
        node_first=jnp.asarray(scene.node_first),
        node_count=jnp.asarray(scene.node_count),
        tri_v0=jnp.asarray(scene.tri_v0),
        tri_v1=jnp.asarray(scene.tri_v1),
        tri_v2=jnp.asarray(scene.tri_v2),
        uv0=jnp.asarray(scene.uv0),
        uv1=jnp.asarray(scene.uv1),
        uv2=jnp.asarray(scene.uv2),
        tri_mat=jnp.asarray(scene.tri_mat),
        tri_n0=jnp.asarray(scene.tri_n0),
        tri_n1=jnp.asarray(scene.tri_n1),
        tri_n2=jnp.asarray(scene.tri_n2),
        mat_diffuse=jnp.asarray(scene.mat_diffuse),
        mat_specular=jnp.asarray(scene.mat_specular),
        mat_emissive=jnp.asarray(scene.mat_emissive),
        mat_specular_ex=jnp.asarray(scene.mat_specular_ex),
        mat_use_texture=jnp.asarray(scene.mat_use_texture),
        mat_tex_index=jnp.asarray(scene.mat_tex_index),
        bvh_nodes=bvh_nodes,
        bvh_tris=bvh_tris,
        tri_leaf=jnp.asarray(tri_leaf),
        refit_internal=jnp.asarray(refit_internal),
        atlas=None if atlas is None else jnp.asarray(atlas),
        atlas_rects=None if atlas_rects is None else jnp.asarray(atlas_rects),
        atlas_mip_rects=(None if atlas_mip_rects is None
                         else jnp.asarray(atlas_mip_rects)),
        atlas_quad=atlas_quad,
        mip_lod_scale=float(mip_lod_scale),
        tri_vidx=jnp.asarray(scene.tri_vidx),
        positions=jnp.asarray(scene.positions),
        tri_adj=(None if scene.tri_adj is None
                 else jnp.asarray(scene.tri_adj)),
        model_first_node=tuple(int(x) for x in scene.model_first_node),
        model_first_tri=tuple(int(x) for x in scene.model_first_tri),
        model_tri_count=tuple(int(x) for x in scene.model_tri_count),
        model_padded_tri_count=padded_counts,
        num_triangles=int(scene.num_triangles),
        stack_depth=int(scene.max_depth) + 2,
        max_leaf=int(scene.node_count.max()),
        refit_level_sizes=level_sizes,
    )


def with_positions(scene: MeshScene, positions) -> MeshScene:
    """Re-gather the per-corner vertex arrays from a shared vertex buffer.

    The differentiable-geometry entry point: parameterize a render by
    ``positions`` [V, 3] and gradients through tri_v0/v1/v2 scatter-add
    back to the *shared* vertices via the gather VJP (BASELINE config 4,
    "vertex + material gradients"; vertex layout parity:
    model_loader.cpp:296-331).  Padding triangles duplicate real triangles
    (utils/flatten.py), so their vidx rows alias real vertices and their
    gradients land on the same shared vertices — consistent by
    construction.

    Note: the BVH node bounds and kernel tables are built from the
    *uploaded* geometry; within one gradient evaluation they agree with
    ``positions``, but after an optimizer step moves vertices call
    ``refit_accel`` (jit-able) so traversal candidates track the geometry.
    Stored shading normals (tri_n0..2) are likewise not re-derived — for
    large vertex moves recompute them host-side
    (utils.obj_loader.compute_vertex_normals) and re-upload, or optimize
    with flat (geometric) shading, which tracks the vertices exactly.
    """
    vidx = scene.tri_vidx
    return scene.replace(
        positions=positions,
        tri_v0=positions[vidx[:, 0]],
        tri_v1=positions[vidx[:, 1]],
        tri_v2=positions[vidx[:, 2]],
    )


def refit_accel(scene: MeshScene) -> MeshScene:
    """Refit the BVH node bounds and kernel tables to the current
    tri_v0/v1/v2 over the uploaded topology (jit-able).

    Leaf bounds are a segment min/max over each leaf's triangles; internal
    nodes are refit bottom-up, one depth level at a time, as the min/max
    of their two children (merged-child layout: ``node_first`` and
    ``node_first + 1``).  Min and max are exact, so the result equals a
    host rebuild of the bounds over the same tree.  Use after optimizer
    steps that move vertices.
    """
    v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
    n_nodes = scene.node_min.shape[0]
    lo = jax.ops.segment_min(jnp.minimum(jnp.minimum(v0, v1), v2),
                             scene.tri_leaf, num_segments=n_nodes)
    hi = jax.ops.segment_max(jnp.maximum(jnp.maximum(v0, v1), v2),
                             scene.tri_leaf, num_segments=n_nodes)
    off = 0
    for size in scene.refit_level_sizes:
        ids = scene.refit_internal[off:off + size]
        off += size
        c = scene.node_first[ids]
        lo = lo.at[ids].set(jnp.minimum(lo[c], lo[c + 1]))
        hi = hi.at[ids].set(jnp.maximum(hi[c], hi[c + 1]))
    nodes, tris = traversal_cuda.pack_tables(
        lo, hi, scene.node_first, scene.node_count, v0, v1, v2)
    return scene.replace(node_min=lo, node_max=hi, bvh_nodes=nodes,
                         bvh_tris=tris)


def transform_rays(frame, origins, dirs):
    """World ray -> model space (raytrace_compute.glsl:146-147):
    origin as a point, direction as a vector (no normalize).
    origins/dirs: [3, N] component-first (ops/vec.py)."""
    rot = frame[:3, :3]
    o = jnp.dot(rot, origins, precision=HIGHEST) + frame[:3, 3][:, None]
    d = jnp.dot(rot, dirs, precision=HIGHEST)
    return o, d


def normal_to_world(frame, normals):
    """Model-space normal -> world, via the transpose of the world->model
    matrix; renormalized.  (The reference skips this —
    raytrace_compute.glsl:157 — which is only correct for identity frames.)
    """
    from srt_tpu.ops.safemath import safe_normalize
    return safe_normalize(jnp.dot(normals, frame[:3, :3], precision=HIGHEST))


# ---------------------------------------------------------------------------
# Dense strategy
# ---------------------------------------------------------------------------

def _dense_model_hit(scene: MeshScene, b: int, origins, dirs, t_best):
    """All-triangles sweep for model ``b``; returns (t, tri_idx, u, v).
    origins/dirs [3, N]; the dense MT kernel keeps its [N, T] layout."""
    lo = scene.model_first_tri[b]
    hi = lo + scene.model_tri_count[b]
    o_m, d_m = transform_rays(scene.frames[b], origins, dirs)
    t_all, u_all, v_all = intersect.moller_trumbore(
        o_m.T, d_m.T, scene.tri_v0[lo:hi], scene.tri_v1[lo:hi], scene.tri_v2[lo:hi]
    )
    t_all = jnp.where(t_all < t_best[:, None], t_all, INF)
    k = jnp.argmin(t_all, axis=1)
    rows = jnp.arange(t_all.shape[0])
    return (
        t_all[rows, k],
        (k + lo).astype(jnp.int32),
        u_all[rows, k],
        v_all[rows, k],
    )


# ---------------------------------------------------------------------------
# BVH stack strategy (the reference algorithm, lax.while_loop + vmap)
# ---------------------------------------------------------------------------

def _bvh_traverse_single(scene: MeshScene, root: int, o, d, t_init):
    """One ray through one model's BVH — ``Intersects``
    (ray_intersects.glsl:99-133) as a while_loop with a fixed stack.
    Returns the candidate (t, triangle)."""
    stack = jnp.zeros((scene.stack_depth,), jnp.int32).at[0].set(root)
    tv0, tv1, tv2 = (jax.lax.stop_gradient(x)
                     for x in (scene.tri_v0, scene.tri_v1, scene.tri_v2))

    def mt_one(idx):
        v0 = tv0[idx]
        e1 = tv1[idx] - v0
        e2 = tv2[idx] - v0
        h = jnp.cross(d, e2)
        a = jnp.sum(e1 * h)
        parallel = jnp.abs(a) < intersect.MT_PARALLEL_EPS
        f = 1.0 / jnp.where(parallel, 1.0, a)
        s = o - v0
        u = f * jnp.sum(s * h)
        q = jnp.cross(s, e1)
        v = f * jnp.sum(d * q)
        t = f * jnp.sum(e2 * q)
        miss = parallel | (u < 0) | (u > 1) | (v < 0) | (u + v > 1) \
            | (t <= intersect.MT_HIT_EPS)
        return jnp.where(miss, INF, t)

    def cond(state):
        sp, *_ = state
        return sp > 0

    def body(state):
        sp, stack, best_t, best_i = state
        sp = sp - 1
        ni = stack[sp]
        dist = intersect.box_entry(o, d, scene.node_min[ni], scene.node_max[ni])
        enter = (dist < best_t) & jnp.isfinite(dist)
        first = scene.node_first[ni]
        count = scene.node_count[ni]
        is_leaf = count > 0

        # Leaf: prims statically unrolled to the scene's max leaf size with
        # masks (degenerate midpoint splits can leave leaves > leaf_size,
        # exactly like the reference builder, bvh.h:129-131).
        for k in range(scene.max_leaf):
            idx = first + k
            valid = enter & is_leaf & (k < count)
            t = mt_one(idx)
            better = valid & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_i = jnp.where(better, idx, best_i)

        # Internal: push both children (left processed first, like the
        # reference's pop order).
        push = enter & ~is_leaf
        stack = stack.at[sp].set(jnp.where(push, first + 1, stack[sp]))
        nxt = jnp.minimum(sp + 1, scene.stack_depth - 1)
        stack = stack.at[nxt].set(jnp.where(push, first, stack[nxt]))
        sp = jnp.where(push, sp + 2, sp)
        return sp, stack, best_t, best_i

    init = (jnp.int32(1), stack, t_init, MISS)
    _, _, t, i = jax.lax.while_loop(cond, body, init)
    return t, i


def _bvh_model_hit(scene: MeshScene, b: int, origins, dirs, t_best,
                   any_hit=False, t_min=0.0):
    """Candidate (t, triangle) for model ``b`` from the vmapped stack walk
    on ``stop_gradient``'d operands (a while_loop has no reverse-mode
    rule; ``mesh_hit_fn`` refines the winner differentiably).  ``any_hit``
    and ``t_min`` are accepted for signature parity with the kernel; the
    walk always finds the closest hit."""
    sg = jax.lax.stop_gradient
    o_m, d_m = transform_rays(sg(scene.frames[b]), sg(origins), sg(dirs))
    root = scene.model_first_node[b]
    t_init = jnp.broadcast_to(sg(jnp.asarray(t_best, jnp.float32)),
                              (origins.shape[1],))
    return jax.vmap(
        lambda o, d, tb: _bvh_traverse_single(scene, root, o, d, tb)
    )(o_m.T, d_m.T, t_init)


def _cuda_model_hit(scene: MeshScene, b: int, origins, dirs, t_best,
                    any_hit=False, t_min=0.0):
    """Candidate (t, triangle) for model ``b`` from the GPU kernel."""
    o_m, d_m = transform_rays(scene.frames[b], origins, dirs)
    return traversal_cuda.traverse(
        scene.bvh_nodes, scene.bvh_tris, o_m, d_m, t_best,
        root=scene.model_first_node[b], stack_depth=scene.stack_depth,
        any_hit=any_hit, t_min=t_min)


def candidate_model_hit(scene: MeshScene, method: str):
    """The per-model candidate search of a ``CANDIDATE_METHODS`` strategy:
    ``(scene, b, origins, dirs, t_best, any_hit, t_min) -> (t, tri)``."""
    if method == "cuda":
        traversal_cuda.require_gpu()
        return _cuda_model_hit
    if method == "bvh":
        return _bvh_model_hit
    raise ValueError(f"not a candidate traversal method: {method}")


# ---------------------------------------------------------------------------
# Shading hookup
# ---------------------------------------------------------------------------

def _mip_lod(scene: MeshScene, t, cone=None):
    """Mip LOD; None when mips are absent or disabled.

    Default: the scalar distance heuristic lod = log2(t * scale).  With a
    ray ``cone`` (width-at-origin [N], spread [N]; RenderConfig.ray_cones)
    the footprint at the hit is width + t * spread and ``mip_lod_scale``
    acts as texels-per-world-unit — true footprint tracking through
    bounces (the GL driver analog: derivative-driven mipmapped samplers,
    include/asset_utils/gpu_texture.h:39-53)."""
    if scene.atlas_mip_rects is None or scene.mip_lod_scale <= 0.0:
        return None
    if cone is not None:
        width, spread = cone
        fp = width + t * spread
        return jnp.log2(jnp.maximum(fp * scene.mip_lod_scale, 1.0))
    return jnp.log2(jnp.maximum(t * scene.mip_lod_scale, 1.0))


def triangle_material(scene: MeshScene, tri_idx, u, v, t=None,
                      cone=None) -> Materials:
    """OBJ material -> shading material (``TriangleToSupportedMat``,
    raytrace_utils.glsl:140-175): textured albedo via barycentric UV lookup
    in the atlas (trilinear through the mip chain when ``t`` and mips are
    available), else Kd; roughness ~ 1/(Ns+eps); metalness 0.1;
    use_spec true."""
    midx = scene.tri_mat[tri_idx]
    albedo = scene.mat_diffuse[midx]
    if scene.atlas is not None:
        from srt_tpu.ops.texture import sample_atlas
        uv = (
            (1.0 - u - v)[:, None] * scene.uv0[tri_idx]
            + u[:, None] * scene.uv1[tri_idx]
            + v[:, None] * scene.uv2[tri_idx]
        )
        lod = None if t is None else _mip_lod(scene, t, cone=cone)
        tex_rgb = sample_atlas(
            scene.atlas, scene.atlas_rects, scene.mat_tex_index[midx], uv,
            mip_rects=scene.atlas_mip_rects, lod=lod,
            quad=scene.atlas_quad,
        )
        albedo = jnp.where(scene.mat_use_texture[midx][:, None], tex_rgb, albedo)
    rough = 1.0 / (scene.mat_specular_ex[midx] + ROUGHNESS_EPS)
    n = tri_idx.shape[0]
    return Materials(
        albedo=albedo,
        specular=scene.mat_specular[midx],
        roughness=rough,
        metalness=jnp.full((n,), MESH_METALNESS, jnp.float32),
        use_spec=jnp.ones((n,), bool),
    )


def _tri_record(scene: MeshScene) -> jnp.ndarray:
    """Pack everything shading needs per triangle into one [T, 36] table.

    The post-hit pass does ONE ``record[idx]`` gather instead of ~12
    separate vertex/uv/material gathers (ops/gather.py).  Layout (36 columns): v0 v1 v2
    (0-8), uv0 uv1 uv2 (9-14), Kd (15-17), Ks (18-20), Ns (21), use_tex
    (22), tex_idx (23), Ke (24-26), shading normals n0 n1 n2 (27-35, zero
    = geometric).  Built from the
    scene's differentiable arrays inside the trace, so material/vertex
    gradients flow through the packing; the per-triangle material expansion
    is a [T]-sized gather (trivial).
    """
    m = scene.tri_mat
    return jnp.concatenate([
        scene.tri_v0, scene.tri_v1, scene.tri_v2,
        scene.uv0, scene.uv1, scene.uv2,
        scene.mat_diffuse[m], scene.mat_specular[m],
        scene.mat_specular_ex[m][:, None],
        scene.mat_use_texture[m][:, None].astype(jnp.float32),
        scene.mat_tex_index[m][:, None].astype(jnp.float32),
        scene.mat_emissive[m],
        scene.tri_n0, scene.tri_n1, scene.tri_n2,
    ], axis=1)


def _record_material(scene: MeshScene, rec_t, u, v, t=None,
                     cone=None) -> Materials:
    """``TriangleToSupportedMat`` (raytrace_utils.glsl:140-175) from the
    packed per-triangle record (component-first [36, N]) — no per-ray
    table gathers."""
    albedo = rec_t[15:18]
    if scene.atlas is not None:
        from srt_tpu.ops.texture import sample_atlas
        uv = (
            (1.0 - u - v)[None, :] * rec_t[9:11]
            + u[None, :] * rec_t[11:13]
            + v[None, :] * rec_t[13:15]
        )
        lod = None if t is None else _mip_lod(scene, t, cone=cone)
        tex_rgb = sample_atlas(
            scene.atlas, scene.atlas_rects,
            rec_t[23].astype(jnp.int32), uv.T,
            mip_rects=scene.atlas_mip_rects, lod=lod,
            quad=scene.atlas_quad,
        ).T
        albedo = jnp.where(rec_t[22:23] > 0.5, tex_rgb, albedo)
    n = rec_t.shape[1]
    return Materials(
        albedo=albedo,
        specular=rec_t[18:21],
        roughness=1.0 / (rec_t[21] + ROUGHNESS_EPS),
        metalness=jnp.full((n,), MESH_METALNESS, jnp.float32),
        use_spec=jnp.ones((n,), bool),
    )


def mesh_hit_fn(scene: MeshScene, method: str = "dense",
                flip_normals: bool = True, ray_tile: int = 0) -> HitFn:
    """Build the integrator's closest-hit callable for a mesh scene.

    Mirrors the model branch of ``CheckHit`` (raytrace_compute.glsl:143-161):
    per-model frame transform, traversal bounded by the running closest t
    across models, material conversion on the winning triangle.

    ``method`` is a traversal strategy (module docstring; see
    ``default_method``).  ``ray_tile > 0`` processes rays in fixed tiles
    via ``lax.map`` to bound the [tile, T] dense working set; the
    candidate strategies keep O(N) state and ignore it.
    """
    if method in CANDIDATE_METHODS:
        model_hit = candidate_model_hit(scene, method)
        ray_tile = 0
    elif method == "dense":
        model_hit = _dense_model_hit
    else:
        raise ValueError(f"unknown traversal method: {method}")
    candidate = method in CANDIDATE_METHODS

    def hit_tile(origins, dirs, t_min, t_max, any_hit=False, cone=None):
        n = origins.shape[1]
        best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
        best_i = jnp.full((n,), MISS)
        best_u = jnp.zeros((n,), jnp.float32)
        best_v = jnp.zeros((n,), jnp.float32)
        best_b = jnp.zeros((n,), jnp.int32)
        for b in range(scene.num_models):
            if candidate:
                # Candidates only; exact (t, u, v) is re-derived once for
                # the cross-model winner below (one gather, not 3/model).
                t, i = model_hit(scene, b, origins, dirs, best_t,
                                 any_hit=any_hit, t_min=t_min)
                u = v = best_u
            else:
                t, i, u, v = model_hit(scene, b, origins, dirs, best_t)
            better = (i != MISS) & (t < best_t) & (t > t_min)
            best_t = jnp.where(better, t, best_t)
            best_i = jnp.where(better, i, best_i)
            best_u = jnp.where(better, u, best_u)
            best_v = jnp.where(better, v, best_v)
            best_b = jnp.where(better, b, best_b)

        hit = best_i != MISS

        if any_hit:
            # Occlusion only: no shading data, no gathers at all.
            t_safe = jnp.where(hit, best_t, 1.0)
            p = origins + t_safe[None, :] * dirs
            zeros = jnp.zeros_like(p)
            return Hit(
                hit=hit, t=best_t, p=p, normal=zeros,
                mat=Materials(
                    albedo=zeros, specular=zeros,
                    roughness=jnp.ones((n,), jnp.float32),
                    metalness=jnp.zeros((n,), jnp.float32),
                    use_spec=jnp.zeros((n,), bool),
                ),
            )

        # --- Shared post-pass: ONE packed-record gather for the winner,
        # transposed once into the component-first layout ---
        idx = jnp.maximum(best_i, 0)
        rec_t = _tri_record(scene)[idx].T                   # [36, N]
        v0, v1, v2 = rec_t[0:3], rec_t[3:6], rec_t[6:9]
        e1 = v1 - v0
        e2 = v2 - v0

        # Winning model's ray transform (frames table is tiny: per-model
        # transforms selected by where-chain, no [N, 4, 4] gather ever
        # materializes).
        if scene.num_models == 1:
            o_m, d_m = transform_rays(scene.frames[0], origins, dirs)
        else:
            o_m = d_m = None
            for b in range(scene.num_models):
                o_b, d_b = transform_rays(scene.frames[b], origins, dirs)
                if o_m is None:
                    o_m, d_m = o_b, d_b
                else:
                    m = (best_b == b)[None, :]
                    o_m = jnp.where(m, o_b, o_m)
                    d_m = jnp.where(m, d_b, d_m)

        if candidate:
            # Exact Moller-Trumbore refine of the candidate winner so
            # (t, u, v) precision matches the dense path.
            h = vec.cross(d_m, e2)
            a = jnp.sum(e1 * h, axis=0)
            parallel = jnp.abs(a) < intersect.MT_PARALLEL_EPS
            f_inv = 1.0 / jnp.where(parallel, 1.0, a)
            s = o_m - v0
            u_r = f_inv * jnp.sum(s * h, axis=0)
            q = vec.cross(s, e1)
            v_r = f_inv * jnp.sum(d_m * q, axis=0)
            t_r = f_inv * jnp.sum(e2 * q, axis=0)
            best_t = jnp.where(hit, t_r, best_t)
            best_u = jnp.where(hit, u_r, 0.0)
            best_v = jnp.where(hit, v_r, 0.0)

        # Shading normal in model space: barycentric interpolation of the
        # per-corner normals when present (smooth shading; the reference
        # parses vn and discards it, model_loader.cpp:296-331), falling
        # back to the geometric normal wherever the interpolated vector is
        # ~zero (vn-less meshes, padding).  Reference normal convention:
        # model space, raytrace_compute.glsl:157; see RenderConfig.
        n_geom = vec.normalize(vec.cross(e1, e2))
        n_sm = (
            (1.0 - best_u - best_v)[None, :] * rec_t[27:30]
            + best_u[None, :] * rec_t[30:33]
            + best_v[None, :] * rec_t[33:36]
        )
        sm_len2 = jnp.sum(n_sm * n_sm, axis=0)
        use_sm = sm_len2 > 1e-12
        inv_sm = jax.lax.rsqrt(jnp.where(use_sm, sm_len2, 1.0))
        n_model = jnp.where(use_sm[None, :], n_sm * inv_sm[None, :], n_geom)

        # Normal to world via the transpose of world->model.
        if scene.num_models == 1:
            normal = jnp.dot(scene.frames[0][:3, :3].T, n_model,
                             precision=HIGHEST)
        else:
            normal = None
            for b in range(scene.num_models):
                n_b = jnp.dot(scene.frames[b][:3, :3].T, n_model,
                              precision=HIGHEST)
                if normal is None:
                    normal = n_b
                else:
                    normal = jnp.where((best_b == b)[None, :], n_b, normal)
        normal = vec.normalize(normal)

        t_safe = jnp.where(hit, best_t, 1.0)
        p = origins + t_safe[None, :] * dirs

        if flip_normals:
            facing = jnp.sum(normal * dirs, axis=0) < 0.0
            normal = jnp.where(facing[None, :], normal, -normal)

        mat = _record_material(scene, rec_t, best_u, best_v, t=t_safe,
                               cone=cone)
        # Emission (Ke) rides the Hit record; the integrator credits
        # throughput * Ke on hit — mesh area emitters, a capability the
        # reference parses but never uses (model_loader.cpp:240-273).
        emitted = jnp.where(hit[None, :], rec_t[24:27], 0.0)
        return Hit(hit=hit, t=best_t, p=p, normal=normal, mat=mat,
                   emitted=emitted,
                   tri=jnp.where(hit, idx, -1).astype(jnp.int32))

    if ray_tile <= 0:
        return hit_tile

    def hit_tiled(origins, dirs, t_min, t_max, any_hit=False, cone=None):
        n = origins.shape[1]
        if n <= ray_tile:
            return hit_tile(origins, dirs, t_min, t_max, any_hit=any_hit,
                            cone=cone)
        pad = (-n) % ray_tile
        o = jnp.pad(origins, ((0, 0), (0, pad)))
        d = jnp.pad(dirs, ((0, 0), (0, pad)), constant_values=1.0)
        tm = jnp.pad(jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,)),
                     (0, pad), constant_values=1.0)
        tiles = (n + pad) // ray_tile
        if cone is None:
            cw = ct = jnp.zeros((n + pad,), jnp.float32)
        else:
            cw = jnp.pad(cone[0], (0, pad))
            ct = jnp.pad(cone[1], (0, pad))
        res = jax.lax.map(
            lambda args: hit_tile(args[0], args[1], t_min, args[2],
                                  any_hit=any_hit,
                                  cone=(None if cone is None
                                        else (args[3], args[4]))),
            (
                o.reshape(3, tiles, ray_tile).transpose(1, 0, 2),
                d.reshape(3, tiles, ray_tile).transpose(1, 0, 2),
                tm.reshape(tiles, ray_tile),
                cw.reshape(tiles, ray_tile),
                ct.reshape(tiles, ray_tile),
            ),
        )

        def unstack(x):
            # Per-tile results: [tiles, ...] with the ray axis last for
            # vectors ([tiles, 3, tile]) and direct for scalars.
            if x.ndim == 3:
                return x.transpose(1, 0, 2).reshape(x.shape[1], -1)[:, :n]
            return x.reshape(-1)[:n]

        return jax.tree_util.tree_map(unstack, res)

    return hit_tiled


def load_mesh_scene(obj_paths, frames=None, method_pad: int = 1,
                    leaf_size: int = 2) -> MeshScene:
    """Convenience: OBJ paths -> flattened device MeshScene."""
    from srt_tpu.utils.flatten import flatten_models
    from srt_tpu.utils.obj_loader import load_object

    meshes = [load_object(p) for p in obj_paths]
    flat = flatten_models(meshes, frames=frames, leaf_size=leaf_size,
                          pad_to=method_pad)
    return upload(flat)
