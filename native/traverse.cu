// CUDA BVH traversal over the 8-wide accel rows (tpurt/bvh/wide.py WideBVH),
// called from JAX through the XLA foreign function interface
// (tpurt/kernels/traverse.py).
//
// One thread traces one ray with a private stack; each warp covers a compact
// tile of pixels (tile_w x 32/tile_w) so its rays walk similar nodes. The
// accel stays in device memory (node and leaf rows are read through the
// read-only path as float4; a Sponza-class accel fits in L2).
//
// Row layouts (unchanged from the XLA walk, tpurt/bvh/traverse.py):
//   nodes f32[Nw, 128]: child c at floats [16c, 16c+16) =
//         bmin.xyz, bmax.xyz, ref, 0...; ref >= 0 is a node row, ref < 0 a
//         leaf row -(ref+1); an empty slot has an inverted box (min > max).
//   tris  f32[L, 128]: leaf triangle j at floats [9j, 9j+9) = v0, e1, e2.
//   rays  f32[N, 8]: origin.xyz, dir.xyz, t_max, unused.
//
// Semantics match traverse_wide: slab test with the inverse direction
// clamped to +-3.4e38 (no NaN from axis-parallel rays), empty slots never
// hit, two-sided Moller-Trumbore with |det| < 1e-9 rejected, a hit counts
// when t_min < t < best_t. Closest hit returns (t, sorted triangle index);
// any hit returns an occlusion flag. A walk that would overflow the stack
// or passes the iteration cap is counted in the error output.
//
// The per-thread stack has one of three sizes (64, 128 or 256 entries, one
// kernel instantiation each), chosen by the caller from the tree's depth
// (tpurt/bvh/wide.py size_stack: 7 * levels + 1 entries always suffice).

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kRowFloats = 128;
constexpr int kMaxLeafSize = 14;  // 14 * 9 floats fill one 128-float row
constexpr float kBig = 3.4e38f;
constexpr float kInf = __builtin_huge_valf();
constexpr int kBlockThreads = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float clamped_inverse(float d) {
  return fminf(fmaxf(1.0f / d, -kBig), kBig);
}

// Slab test of one child slot. a = (bmin.xyz, bmax.x), b = (bmax.yz, ref, 0).
__device__ __forceinline__ bool slab(const float4& a, const float4& b,
                                     const Ray& r, float t_min, float t_cap,
                                     float* enter) {
  const float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
  const float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
  const float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
  const float lo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fmaxf(fminf(t0z, t1z), t_min));
  const float hi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fminf(fmaxf(t0z, t1z), t_cap));
  *enter = lo;
  return lo <= hi && a.x <= a.w;
}

// Two-sided Moller-Trumbore on one (v0, e1, e2) record; +inf on a miss.
__device__ __forceinline__ float triangle_t(const float* f, const Ray& r) {
  const float v0x = f[0], v0y = f[1], v0z = f[2];
  const float e1x = f[3], e1y = f[4], e1z = f[5];
  const float e2x = f[6], e2y = f[7], e2z = f[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (fabsf(det) < 1e-9f) return kInf;
  const float inv_det = 1.0f / det;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool ok = u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
  return ok ? t : kInf;
}

// Test the k triangles of one leaf row, four at a time (four records are
// nine float4 loads). Closest hit lowers *best_t / *best_i; any hit returns
// true on the first triangle in (t_min, *best_t).
template <bool kAnyHit>
__device__ __forceinline__ bool test_leaf(const float* __restrict__ tris,
                                          int leaf, int k, const Ray& r,
                                          float t_min, float* best_t,
                                          int* best_i) {
  const float* row = tris + static_cast<size_t>(leaf) * kRowFloats;
  for (int g = 0; g < k; g += 4) {
    const int ntri = min(4, k - g);
    const int nq = (9 * ntri + 3) / 4;  // stays inside the 128-float row
    const float4* p = reinterpret_cast<const float4*>(row + 9 * g);
    float f[36];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      if (q < nq) {
        const float4 v = __ldg(p + q);
        f[4 * q] = v.x;
        f[4 * q + 1] = v.y;
        f[4 * q + 2] = v.z;
        f[4 * q + 3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < ntri) {
        const float t = triangle_t(f + 9 * j, r);
        if (t > t_min && t < *best_t) {
          if (kAnyHit) return true;
          *best_t = t;
          *best_i = leaf * k + g + j;
        }
      }
    }
  }
  return false;
}

template <bool kAnyHit, int kStackDepth>
__global__ void __launch_bounds__(kBlockThreads)
    walk_kernel(const float4* __restrict__ nodes,
                const float* __restrict__ tris,
                const float4* __restrict__ rays, int width, int height,
                int tile_w, int k, int max_iters, float t_min,
                float* __restrict__ t_out, int32_t* __restrict__ idx_out,
                int32_t* __restrict__ errors) {
  // Warp -> tile of tile_w x (32 / tile_w) rays in row-major ray order.
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int warp = gid >> 5, lane = gid & 31;
  const int tile_h = 32 / tile_w;
  const int tiles_x = (width + tile_w - 1) / tile_w;
  const int x = (warp % tiles_x) * tile_w + lane % tile_w;
  const int y = (warp / tiles_x) * tile_h + lane / tile_w;
  if (x >= width || y >= height) return;
  const int i = y * width + x;

  const float4 ra = rays[2 * i], rb = rays[2 * i + 1];
  Ray r;
  r.ox = ra.x; r.oy = ra.y; r.oz = ra.z;
  r.dx = ra.w; r.dy = rb.x; r.dz = rb.y;
  r.ix = clamped_inverse(r.dx);
  r.iy = clamped_inverse(r.dy);
  r.iz = clamped_inverse(r.dz);
  const float t_max = rb.z;

  float best_t = t_max;
  int best_i = -1;
  bool found = false, error = false;
  int stack[kStackDepth];
  int sp = 0;
  if (t_max > t_min) stack[sp++] = 0;
  int iters = 0;
  while (sp > 0) {
    if (++iters > max_iters) {
      error = true;
      break;
    }
    const float4* row = nodes + static_cast<size_t>(stack[--sp]) * 32;
    float enter[8];
    int ref[8];
    unsigned inner = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 a = __ldg(row + 4 * c);
      const float4 b = __ldg(row + 4 * c + 1);
      ref[c] = static_cast<int>(b.z);
      if (slab(a, b, r, t_min, best_t, &enter[c])) {
        if (ref[c] < 0) {
          // Leaves are tested on the spot: a closer hit tightens best_t
          // before the internal children are pushed.
          if (test_leaf<kAnyHit>(tris, -ref[c] - 1, k, r, t_min, &best_t,
                                 &best_i)) {
            found = true;
          }
        } else {
          inner |= 1u << c;
        }
      }
    }
    if (found) break;
    // Push the internal hits farthest first, so the nearest pops next.
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (inner == 0) break;
      int pick = -1;
      float far = -kInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        // Ties in entry distance go to the lower slot, which is pushed
        // first: the highest slot pops first, as in the XLA walk.
        if ((inner >> c & 1u) && (kAnyHit || enter[c] <= best_t) &&
            enter[c] > far) {
          far = enter[c];
          pick = c;
        }
      }
      if (pick < 0) break;  // the rest now lie behind best_t
      int pushed = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (c == pick) pushed = ref[c];
      }
      inner &= ~(1u << pick);
      if (sp == kStackDepth) {
        error = true;
        sp = 0;
        break;
      }
      stack[sp++] = pushed;
    }
  }
  if (error) atomicAdd(errors, 1);
  if (kAnyHit) {
    idx_out[i] = found ? 1 : 0;
  } else {
    t_out[i] = best_i >= 0 ? best_t : kInf;
    idx_out[i] = best_i;
  }
}

struct Launch {
  int width, height, tile_w, k, max_iters, stack_depth;
};

ffi::Error check(const ffi::Buffer<ffi::F32>& nodes,
                 const ffi::Buffer<ffi::F32>& tris,
                 const ffi::Buffer<ffi::F32>& rays, const Launch& l) {
  if (nodes.element_count() % kRowFloats || nodes.element_count() == 0 ||
      tris.element_count() % kRowFloats || tris.element_count() == 0) {
    return ffi::Error::InvalidArgument("accel rows must be f32[*, 128]");
  }
  if (l.k < 1 || l.k > kMaxLeafSize) {
    return ffi::Error::InvalidArgument("leaf_size must be in 1..14");
  }
  if (l.stack_depth != 64 && l.stack_depth != 128 && l.stack_depth != 256) {
    return ffi::Error::InvalidArgument("stack_depth must be 64, 128 or 256");
  }
  if (l.tile_w < 1 || l.tile_w > 32 || 32 % l.tile_w) {
    return ffi::Error::InvalidArgument("tile_w must divide 32");
  }
  if (l.width < 1 || l.height < 1 ||
      rays.element_count() != static_cast<size_t>(l.width) * l.height * 8) {
    return ffi::Error::InvalidArgument("rays must be f32[width*height, 8]");
  }
  return ffi::Error::Success();
}

template <bool kAnyHit>
ffi::Error enqueue(cudaStream_t stream, const ffi::Buffer<ffi::F32>& nodes,
                   const ffi::Buffer<ffi::F32>& tris,
                   const ffi::Buffer<ffi::F32>& rays, const Launch& l,
                   float t_min, float* t_out, int32_t* idx_out,
                   int32_t* errors) {
  ffi::Error bad = check(nodes, tris, rays, l);
  if (bad.failure()) return bad;
  cudaMemsetAsync(errors, 0, sizeof(int32_t), stream);
  const int tile_h = 32 / l.tile_w;
  const long long warps =
      static_cast<long long>((l.width + l.tile_w - 1) / l.tile_w) *
      ((l.height + tile_h - 1) / tile_h);
  const long long blocks = (warps * 32 + kBlockThreads - 1) / kBlockThreads;
  auto kernel = l.stack_depth == 64    ? walk_kernel<kAnyHit, 64>
                : l.stack_depth == 128 ? walk_kernel<kAnyHit, 128>
                                       : walk_kernel<kAnyHit, 256>;
  kernel<<<static_cast<unsigned>(blocks), kBlockThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes.typed_data()), tris.typed_data(),
      reinterpret_cast<const float4*>(rays.typed_data()), l.width, l.height,
      l.tile_w, l.k, l.max_iters, t_min, t_out, idx_out, errors);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error closest_hit(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                       ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> rays,
                       ffi::ResultBuffer<ffi::F32> t_out,
                       ffi::ResultBuffer<ffi::S32> idx_out,
                       ffi::ResultBuffer<ffi::S32> errors, float t_min,
                       int32_t width, int32_t height, int32_t tile_w,
                       int32_t leaf_size, int32_t max_iters,
                       int32_t stack_depth) {
  return enqueue<false>(stream, nodes, tris, rays,
                        {width, height, tile_w, leaf_size, max_iters,
                         stack_depth},
                        t_min,
                        t_out->typed_data(), idx_out->typed_data(),
                        errors->typed_data());
}

ffi::Error any_hit(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                   ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> rays,
                   ffi::ResultBuffer<ffi::S32> occluded,
                   ffi::ResultBuffer<ffi::S32> errors, float t_min,
                   int32_t width, int32_t height, int32_t tile_w,
                   int32_t leaf_size, int32_t max_iters,
                   int32_t stack_depth) {
  return enqueue<true>(stream, nodes, tris, rays,
                       {width, height, tile_w, leaf_size, max_iters,
                        stack_depth},
                       t_min,
                       nullptr, occluded->typed_data(), errors->typed_data());
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RtClosestHit, closest_hit,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rays
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // index
                                  .Ret<ffi::Buffer<ffi::S32>>()  // errors
                                  .Attr<float>("t_min")
                                  .Attr<int32_t>("width")
                                  .Attr<int32_t>("height")
                                  .Attr<int32_t>("tile_w")
                                  .Attr<int32_t>("leaf_size")
                                  .Attr<int32_t>("max_iters")
                                  .Attr<int32_t>("stack_depth"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(RtAnyHit, any_hit,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rays
                                  .Ret<ffi::Buffer<ffi::S32>>()  // occluded
                                  .Ret<ffi::Buffer<ffi::S32>>()  // errors
                                  .Attr<float>("t_min")
                                  .Attr<int32_t>("width")
                                  .Attr<int32_t>("height")
                                  .Attr<int32_t>("tile_w")
                                  .Attr<int32_t>("leaf_size")
                                  .Attr<int32_t>("max_iters")
                                  .Attr<int32_t>("stack_depth"));
