"""Multi-model scene flattening — the device-upload layer.

Analog of ``AssetUtils::UploadModelDataToGPU`` (src/asset_utils/
gpu_loader.cpp:63-183): N models (mesh + BVH + materials) are flattened into
global arrays with running offsets — per-model node ranges and frame
matrices, BVH nodes with the merged child/prim index fixed up
(gpu_loader.cpp:119-130), triangles with vertex/material offsets applied
(:107-115) — except the destination is a pytree of numpy arrays destined for
HBM (``jax.device_put`` replicated per host) instead of five SSBOs.

Device-side choices:
* triangle vertex positions and UVs are **pre-gathered** per corner
  (tri_v0/v1/v2, uv0/1/2) so the intersection code does zero indirection;
  the index form (tri_vidx) is kept for vertex-gradient scatter-back;
* optionally each model's triangle block is padded to a multiple of
  ``pad_to`` with duplicates of its last triangle, which no BVH leaf
  references.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from srt_tpu.utils.bvh import FlatBVH, triangle_bvh
from srt_tpu.utils.obj_loader import MeshData


@dataclasses.dataclass
class FlatScene:
    """Flattened multi-model scene (host numpy).  See module docstring."""

    # BVH directory: per model (``GPUBVH``, gpu_loader.cpp:11-17)
    model_first_node: np.ndarray  # [B] int32
    model_node_count: np.ndarray  # [B] int32
    model_first_tri: np.ndarray   # [B] int32
    model_tri_count: np.ndarray   # [B] int32
    frames: np.ndarray            # [B, 4, 4] float32 world->model
    # nodes (``GPUBVHNode``, gpu_loader.cpp:19-24), merged-index layout
    node_min: np.ndarray          # [Nn, 3]
    node_max: np.ndarray          # [Nn, 3]
    node_first: np.ndarray        # [Nn] int32 (child idx or global tri idx)
    node_count: np.ndarray        # [Nn] int32 (0 = internal)
    # triangles, pre-gathered corners
    tri_v0: np.ndarray            # [T, 3]
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    uv0: np.ndarray               # [T, 2]
    uv1: np.ndarray
    uv2: np.ndarray
    tri_mat: np.ndarray           # [T] int32
    tri_n0: np.ndarray            # [T, 3] shading normals (zero = use
    tri_n1: np.ndarray            #        the geometric normal)
    tri_n2: np.ndarray
    tri_vidx: np.ndarray          # [T, 3] int32 into the packed vertex buffer
    positions: np.ndarray         # [V, 3] packed vertex buffer (for grads)
    # materials (``GPUMaterial``, gpu_loader.cpp:26-34)
    mat_diffuse: np.ndarray       # [M, 3]
    mat_specular: np.ndarray      # [M, 3]
    mat_emissive: np.ndarray      # [M, 3] (Ke; zero = non-emitter)
    mat_specular_ex: np.ndarray   # [M]
    mat_use_texture: np.ndarray   # [M] bool
    mat_tex_index: np.ndarray     # [M] int32 into the atlas (-1 = none)
    # edge adjacency: tri_adj[t, k] = triangle sharing edge k of t (edge k
    # joins corners k and (k+1)%3), -1 at mesh boundaries and on padding
    # rows — the topology the mesh silhouette gradients walk
    # (models/edge_aware_mesh.py)
    tri_adj: np.ndarray = None    # [T, 3] int32
    num_triangles: int = 0        # real (unpadded) triangle count
    max_depth: int = 32           # deepest BVH depth across models

    @property
    def num_models(self) -> int:
        return self.model_first_node.shape[0]


def triangle_adjacency(vidx: np.ndarray, n_real: int,
                       positions: np.ndarray = None) -> np.ndarray:
    """Edge-adjacency of one model's triangles (vectorized).

    ``vidx`` [T_padded, 3] vertex indices in BVH order; only the first
    ``n_real`` rows are real (padding rows duplicate real triangles and
    must not join the topology).  When ``positions`` is given, vertices
    are first WELDED by exact coordinate equality, so meshes that
    duplicate corners (triangle soup — e.g. the procgen primitives, or
    OBJ models with per-corner splits) still get a closed topology.
    Returns [T_padded, 3] int32 where entry (t, k) is the LOCAL index of
    the triangle sharing edge k of t (edge k joins corners k and
    (k+1)%3), or -1 for boundary edges, padding rows, and non-manifold
    extras (best-effort: a >2-triangle edge pairs its first two sides).
    """
    t_padded = vidx.shape[0]
    adj = np.full(3 * t_padded, -1, np.int64)
    if n_real:
        a = vidx[:n_real].astype(np.int64)
        if positions is not None:
            _, weld = np.unique(np.asarray(positions, np.float32),
                                axis=0, return_inverse=True)
            a = weld.astype(np.int64)[a]
        e = np.concatenate([
            np.stack([a[:, 0], a[:, 1]], 1),
            np.stack([a[:, 1], a[:, 2]], 1),
            np.stack([a[:, 2], a[:, 0]], 1),
        ], axis=0)                                     # edge i = k*n + tri
        key = e.min(1) * (a.max() + 1) + e.max(1)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        pair = np.nonzero(ks[:-1] == ks[1:])[0]
        # Non-manifold guard: a run of 3+ equal keys would chain pairs;
        # keep only the first pair of each run.
        if pair.size:
            keep = np.ones(pair.size, bool)
            keep[1:] = pair[1:] != pair[:-1] + 1
            pair = pair[keep]
        ea, eb = order[pair], order[pair + 1]
        # adj is indexed by padded edge id k*t_padded + tri.
        def eid(i):
            return (i // n_real) * t_padded + (i % n_real)
        adj[eid(ea)] = eb % n_real
        adj[eid(eb)] = ea % n_real
    return adj.reshape(3, t_padded).T.astype(np.int32)


def flatten_models(
    meshes: Sequence[MeshData],
    bvhs: Optional[Sequence[FlatBVH]] = None,
    frames: Optional[Sequence[np.ndarray]] = None,
    leaf_size: int = 2,
    pad_to: int = 1,
) -> FlatScene:
    """Flatten models into one FlatScene.

    ``frames`` are world->model matrices (identity by default, like the
    reference's ``glm::mat4(1)`` GPUBVH default); update later via
    ``set_frame`` for the ``UpdateModelMatrix`` analog
    (gpu_loader.cpp:185-196).

    ``pad_to > 1`` pads **each model's** triangle block (not just the tail)
    to a multiple of ``pad_to`` with copies of its last triangle, which
    no leaf references, so fixed-size triangle blocks never straddle
    models.
    """
    from srt_tpu.utils.bvh import bvh_depth

    if bvhs is None:
        bvhs = [triangle_bvh(m.positions, m.tri_vidx, leaf_size=leaf_size)
                for m in meshes]
    if frames is None:
        frames = [np.eye(4, dtype=np.float32) for _ in meshes]

    first_nodes, node_counts, first_tris, tri_counts, frame_list = [], [], [], [], []
    nmin, nmax, nfirst, ncount = [], [], [], []
    tv0, tv1, tv2, u0, u1, u2, tmat, tvidx = [], [], [], [], [], [], [], []
    tn0, tn1, tn2, tadj = [], [], [], []
    positions = []
    md, ms, mem, mex, mut, mti = [], [], [], [], [], []

    node_off = 0
    tri_off = 0
    mat_off = 0
    vert_off = 0
    depth = 1
    for mesh, bvh, frame in zip(meshes, bvhs, frames):
        depth = max(depth, bvh_depth(bvh))
        first_nodes.append(node_off)
        node_counts.append(bvh.num_nodes)
        first_tris.append(tri_off)
        tri_counts.append(mesh.num_triangles)
        frame_list.append(np.asarray(frame, np.float32))

        is_leaf = bvh.node_count > 0
        nfirst.append(
            np.where(is_leaf, bvh.node_first + tri_off, bvh.node_first + node_off)
            .astype(np.int32)
        )
        ncount.append(bvh.node_count.astype(np.int32))
        nmin.append(bvh.node_min)
        nmax.append(bvh.node_max)

        order = bvh.prim_order
        vidx = mesh.tri_vidx[order]
        n_real = mesh.num_triangles
        n_padded = -(-n_real // pad_to) * pad_to if pad_to > 1 else n_real
        n_pad = n_padded - n_real

        def padded(arr, pad_shape, pad_val=0.0, dtype=np.float32):
            # Pad with copies of the last real triangle: duplicates can tie
            # the closest hit but never change it, shade identically, and
            # keep cluster AABBs tight (degenerate-at-origin pads would
            # bloat them).
            arr = np.asarray(arr, dtype)
            if n_pad:
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], n_pad, axis=0)], axis=0
                )
            return arr

        tv0.append(padded(mesh.positions[vidx[:, 0]], (3,)))
        tv1.append(padded(mesh.positions[vidx[:, 1]], (3,)))
        tv2.append(padded(mesh.positions[vidx[:, 2]], (3,)))
        u0.append(padded(mesh.uvs[vidx[:, 0]], (2,)))
        u1.append(padded(mesh.uvs[vidx[:, 1]], (2,)))
        u2.append(padded(mesh.uvs[vidx[:, 2]], (2,)))
        nsrc = getattr(mesh, "normals", None)
        if nsrc is None:
            nsrc = np.zeros_like(mesh.positions)
        tn0.append(padded(nsrc[vidx[:, 0]], (3,)))
        tn1.append(padded(nsrc[vidx[:, 1]], (3,)))
        tn2.append(padded(nsrc[vidx[:, 2]], (3,)))
        tmat.append(padded(mesh.tri_mat[order].astype(np.int64) + mat_off,
                           (), 0, np.int32))
        tvidx.append(padded(vidx.astype(np.int64) + vert_off, (3,), 0, np.int32))
        positions.append(mesh.positions)
        adj_local = triangle_adjacency(
            np.concatenate([vidx, np.repeat(vidx[-1:], n_pad, axis=0)])
            if n_pad else vidx, n_real, positions=mesh.positions)
        tadj.append(np.where(adj_local >= 0, adj_local + tri_off,
                             -1).astype(np.int32))

        for m in mesh.materials:
            md.append(m.diffuse)
            ms.append(m.specular)
            mem.append(getattr(m, "emissive", (0.0, 0.0, 0.0)))
            mex.append(m.specular_ex)
            mut.append(bool(m.use_texture))
            mti.append(-1)

        node_off += bvh.num_nodes
        tri_off += n_padded
        mat_off += len(mesh.materials)
        vert_off += mesh.positions.shape[0]

    t = tri_off

    def cat(parts, pad_shape, pad_val=0.0, dtype=np.float32):
        return np.concatenate(parts, axis=0).astype(dtype)

    return FlatScene(
        model_first_node=np.asarray(first_nodes, np.int32),
        model_node_count=np.asarray(node_counts, np.int32),
        model_first_tri=np.asarray(first_tris, np.int32),
        model_tri_count=np.asarray(tri_counts, np.int32),
        frames=np.stack(frame_list, axis=0),
        node_min=np.concatenate(nmin).astype(np.float32),
        node_max=np.concatenate(nmax).astype(np.float32),
        node_first=np.concatenate(nfirst),
        node_count=np.concatenate(ncount),
        tri_v0=cat(tv0, (3,)),
        tri_v1=cat(tv1, (3,)),
        tri_v2=cat(tv2, (3,)),
        uv0=cat(u0, (2,)),
        uv1=cat(u1, (2,)),
        uv2=cat(u2, (2,)),
        tri_mat=cat(tmat, (), 0, np.int32),
        tri_n0=cat(tn0, (3,)),
        tri_n1=cat(tn1, (3,)),
        tri_n2=cat(tn2, (3,)),
        tri_vidx=cat(tvidx, (3,), 0, np.int32),
        positions=np.concatenate(positions).astype(np.float32),
        tri_adj=cat(tadj, (3,), 0, np.int32),
        mat_diffuse=np.asarray(md, np.float32).reshape(-1, 3),
        mat_specular=np.asarray(ms, np.float32).reshape(-1, 3),
        mat_emissive=np.asarray(mem, np.float32).reshape(-1, 3),
        mat_specular_ex=np.asarray(mex, np.float32).reshape(-1),
        mat_use_texture=np.asarray(mut, bool).reshape(-1),
        mat_tex_index=np.asarray(mti, np.int32).reshape(-1),
        num_triangles=t,
        max_depth=depth,
    )


def set_frame(scene: FlatScene, model_index: int, matrix: np.ndarray) -> FlatScene:
    """Replace one model's world->model matrix (``UpdateModelMatrix``,
    gpu_loader.cpp:185-196).  Returns a new FlatScene (host arrays)."""
    frames = scene.frames.copy()
    frames[model_index] = np.asarray(matrix, np.float32)
    return dataclasses.replace(scene, frames=frames)
