// Per-ray BVH traversal for NVIDIA Hopper, called from JAX through the
// XLA foreign function interface (srt_tpu/ops/traversal_cuda.py).
//
// One thread walks one ray through one model's flattened BVH (the merged
// child layout of utils/bvh.py: an internal node's children sit at
// node_first and node_first + 1, a leaf has node_count > 0 and owns the
// triangles [node_first, node_first + node_count)).  The walk is the
// reference's fixed-stack ``Intersects`` loop (ray_intersects.glsl:99-133)
// with two changes: the nearer child is visited first, and a stacked node
// whose entry distance is no longer below the best hit is skipped.
//
// The triangle test is the same Moller-Trumbore arithmetic, epsilons and
// strict ``t < best`` update as the "bvh" and "dense" strategies
// (ops/intersect.py), so all three pick the same winner up to exact-t
// ties.  The kernel is a candidate search: the caller re-derives exact
// (t, u, v) for the winning triangle.
//
// Tables (packed once per upload by traversal_cuda.pack_tables):
//   nodes [Nn, 8] f32: min.xyz, bits(first), max.xyz, bits(count)
//   tris  [T, 12] f32: v0.xyz, 0, e1.xyz, 0, e2.xyz, 0   (BVH order)
// Rays use the wavefront layout: origins / dirs [3, N], t_max [N].
//
// Build: see native/Makefile (target "cuda").

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxStack = 64;
constexpr int kBlock = 128;
constexpr float kParallelEps = 1e-4f;  // intersect.MT_PARALLEL_EPS
constexpr float kHitEps = 1e-5f;       // intersect.MT_HIT_EPS

// Entry distance into the box (0 for an inside origin), +inf when the ray
// misses it or it lies behind the origin: intersect.box_entry, the
// reference's IntersectsBox (ray_intersects.glsl:49-58) with the entry
// clamped for inside origins.  fminf/fmaxf drop a NaN slab (origin on the
// plane of an axis-parallel ray), which keeps the box rather than culling
// it.
__device__ __forceinline__ float box_dist(float4 lo, float4 hi, float3 o,
                                          float3 inv) {
  float tx0 = (lo.x - o.x) * inv.x, tx1 = (hi.x - o.x) * inv.x;
  float ty0 = (lo.y - o.y) * inv.y, ty1 = (hi.y - o.y) * inv.y;
  float tz0 = (lo.z - o.z) * inv.z, tz1 = (hi.z - o.z) * inv.z;
  float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  if (!(tn <= tf) || tf < 0.f) return INFINITY;
  return fmaxf(tn, 0.f);
}

// Moller-Trumbore (ray_intersects.glsl:61-96); +inf on a miss.
__device__ __forceinline__ float tri_t(const float4* __restrict__ tris,
                                       int idx, float3 o, float3 d) {
  float4 a = __ldg(tris + 3 * idx);
  float4 b = __ldg(tris + 3 * idx + 1);
  float4 c = __ldg(tris + 3 * idx + 2);
  float3 e1 = make_float3(b.x, b.y, b.z);
  float3 e2 = make_float3(c.x, c.y, c.z);
  float3 h = make_float3(d.y * e2.z - d.z * e2.y, d.z * e2.x - d.x * e2.z,
                         d.x * e2.y - d.y * e2.x);
  float det = e1.x * h.x + e1.y * h.y + e1.z * h.z;
  if (fabsf(det) < kParallelEps) return INFINITY;
  float f = 1.f / det;
  float3 s = make_float3(o.x - a.x, o.y - a.y, o.z - a.z);
  float u = f * (s.x * h.x + s.y * h.y + s.z * h.z);
  float3 q = make_float3(s.y * e1.z - s.z * e1.y, s.z * e1.x - s.x * e1.z,
                         s.x * e1.y - s.y * e1.x);
  float v = f * (d.x * q.x + d.y * q.y + d.z * q.z);
  float t = f * (e2.x * q.x + e2.y * q.y + e2.z * q.z);
  bool miss = (u < 0.f) | (u > 1.f) | (v < 0.f) | (u + v > 1.f) |
              (t <= kHitEps);
  return miss ? INFINITY : t;
}

__global__ void __launch_bounds__(kBlock)
traverse_kernel(const float4* __restrict__ nodes,
                const float4* __restrict__ tris,
                const float* __restrict__ origins,
                const float* __restrict__ dirs,
                const float* __restrict__ t_max, int64_t n, int root,
                int stack_depth, bool any_hit, float t_min,
                float* __restrict__ t_out, int32_t* __restrict__ i_out) {
  int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (r >= n) return;
  float3 o = make_float3(origins[r], origins[n + r], origins[2 * n + r]);
  float3 d = make_float3(dirs[r], dirs[n + r], dirs[2 * n + r]);
  float3 inv = make_float3(1.f / d.x, 1.f / d.y, 1.f / d.z);
  float best = t_max[r];
  int best_i = -1;

  int stack_node[kMaxStack];
  float stack_dist[kMaxStack];
  int sp = 0;
  int node = -1;
  {
    float dr = box_dist(__ldg(nodes + 2 * root), __ldg(nodes + 2 * root + 1),
                        o, inv);
    if (dr < best) node = root;
  }
  while (node >= 0) {
    float4 lo = __ldg(nodes + 2 * node);
    float4 hi = __ldg(nodes + 2 * node + 1);
    int first = __float_as_int(lo.w);
    int count = __float_as_int(hi.w);
    if (count > 0) {
      for (int k = 0; k < count; ++k) {
        float t = tri_t(tris, first + k, o, d);
        if (t < best && (!any_hit || t > t_min)) {
          best = t;
          best_i = first + k;
          if (any_hit) break;
        }
      }
      if (any_hit && best_i >= 0) break;
    } else {
      float dl = box_dist(__ldg(nodes + 2 * first),
                          __ldg(nodes + 2 * first + 1), o, inv);
      float dr = box_dist(__ldg(nodes + 2 * first + 2),
                          __ldg(nodes + 2 * first + 3), o, inv);
      bool hl = dl < best, hr = dr < best;
      if (hl && hr) {
        bool left_near = dl <= dr;
        // Visit the nearer child now; keep the farther one with its
        // entry distance so a later, closer hit can skip it.
        if (sp < stack_depth) {
          stack_node[sp] = left_near ? first + 1 : first;
          stack_dist[sp] = left_near ? dr : dl;
          ++sp;
        }
        node = left_near ? first : first + 1;
        continue;
      }
      if (hl || hr) {
        node = hl ? first : first + 1;
        continue;
      }
    }
    node = -1;
    while (sp > 0) {
      --sp;
      if (stack_dist[sp] < best) {
        node = stack_node[sp];
        break;
      }
    }
  }
  t_out[r] = best_i >= 0 ? best : INFINITY;
  i_out[r] = best_i;
}

ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                        ffi::Buffer<ffi::F32> tris,
                        ffi::Buffer<ffi::F32> origins,
                        ffi::Buffer<ffi::F32> dirs,
                        ffi::Buffer<ffi::F32> t_max,
                        ffi::ResultBuffer<ffi::F32> t_out,
                        ffi::ResultBuffer<ffi::S32> i_out, int32_t root,
                        int32_t stack_depth, int32_t any_hit, float t_min) {
  int64_t n = static_cast<int64_t>(t_max.element_count());
  if (stack_depth < 1 || stack_depth > kMaxStack) {
    return ffi::Error::InvalidArgument(
        "stack_depth must be in [1, " + std::to_string(kMaxStack) + "]");
  }
  if (origins.element_count() != 3 * static_cast<size_t>(n) ||
      dirs.element_count() != 3 * static_cast<size_t>(n) ||
      nodes.element_count() % 8 != 0 || tris.element_count() % 12 != 0) {
    return ffi::Error::InvalidArgument("bad operand shapes");
  }
  if (n == 0) return ffi::Error::Success();
  int64_t grid = (n + kBlock - 1) / kBlock;
  traverse_kernel<<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()),
      origins.typed_data(), dirs.typed_data(), t_max.typed_data(), n, root,
      stack_depth, any_hit != 0, t_min, t_out->typed_data(), i_out->typed_data());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("bvh traversal launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SrtBvhTraverse, TraverseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Arg<ffi::Buffer<ffi::F32>>()  // origins
                                  .Arg<ffi::Buffer<ffi::F32>>()  // dirs
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_max
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tri
                                  .Attr<int32_t>("root")
                                  .Attr<int32_t>("stack_depth")
                                  .Attr<int32_t>("any_hit")
                                  .Attr<float>("t_min"));
