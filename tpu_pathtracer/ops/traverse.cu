// Per-ray BVH traversal for NVIDIA Hopper, called from JAX through the XLA
// foreign function interface (ops/traverse_gpu.py loads and registers it).
//
// One thread per ray runs the reference's Aila-Laine "Kepler" while-while
// loop (intersectBVHandTriangles, src/renderkernel.cu:136-419): an inner
// loop over BVH nodes (two slab tests with tmin clamping, nearer child
// first, far child pushed) and an inner loop over a leaf's triangles (Woop
// unit-triangle tests), with a private 64-entry stack (STACK_SIZE,
// src/renderkernel.cu:41) and the same SENTINEL termination. Each step does
// exactly what one step of the plain step machine does
// (tracer/traverse.py:_intersect_tile), so the two agree up to float
// contraction.
//
// The scene is the packed (K,16) f32 stream of tracer/traverse.py:
// pack_stream. A 64-byte row is four 16-byte loads through the read-only
// data path (__ldg), the analog of the reference's texture-bound buffers:
//   node row:     c0/c1 boxes in cols 0:12, (child0, child1) bitcast in 12:14
//   triangle row: Woop m0|m1|m2 in cols 0:12, (attr_slot, is_last) in 12:14
// A child >= 0 is a node row; a child < 0 is ~(first triangle row).
//
// Inputs:  packed (K,16) f32, orig (N,3) f32, dir (N,3) f32, tmin (N,) f32,
//          tmax (N,) f32, active (N,) pred, n_active (1,) s32.
// Outputs: hit_slot (N,) s32 (-1 on miss), hit_t (N,) f32 (tmax on miss).
// Attribute: anyhit (s32) - stop at the first hit (shadow rays).
// Lanes at or past n_active, and lanes whose active flag is false, return
// (-1, tmax) at once.
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kSentinel = 0x76543210;  // src/renderkernel.cu:42
constexpr int kStackSize = 64;             // src/renderkernel.cu:41
constexpr int kBlock = 128;

__device__ __forceinline__ float min4(float a, float b, float c, float d) {
  return fminf(fminf(a, b), fminf(c, d));
}

__device__ __forceinline__ float max4(float a, float b, float c, float d) {
  return fmaxf(fmaxf(a, b), fmaxf(c, d));
}

struct Rays {
  const float4* __restrict__ rows;
  const float* __restrict__ orig;
  const float* __restrict__ dir;
  const float* __restrict__ tmin;
  const float* __restrict__ tmax;
  const bool* __restrict__ active;
  const int32_t* __restrict__ n_active;
  int64_t n;
  int32_t* __restrict__ out_slot;
  float* __restrict__ out_t;
};

template <bool kAnyHit>
__device__ __forceinline__ void trace_ray(const Rays& p, int64_t i) {
  const float4* __restrict__ rows = p.rows;
  const float* __restrict__ orig = p.orig;
  const float* __restrict__ dir = p.dir;
  const bool* __restrict__ active = p.active;
  int32_t* __restrict__ out_slot = p.out_slot;
  float* __restrict__ out_t = p.out_t;
  const float tmax = p.tmax[i];
  if (i >= __ldg(p.n_active) || !active[i]) {
    out_slot[i] = -1;
    out_t[i] = tmax;
    return;
  }
  const float tmin = p.tmin[i];
  const float ox = orig[3 * i], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  // ooeps-guarded inverse direction (src/renderkernel.cu:189-192)
  const float ooeps = 8.271806125530277e-25f;  // 2^-80
  const float idx =
      1.0f / (fabsf(dx) > ooeps ? dx : (dx >= 0.0f ? ooeps : -ooeps));
  const float idy =
      1.0f / (fabsf(dy) > ooeps ? dy : (dy >= 0.0f ? ooeps : -ooeps));
  const float idz =
      1.0f / (fabsf(dz) > ooeps ? dz : (dz >= 0.0f ? ooeps : -ooeps));
  const float oodx = ox * idx, oody = oy * idy, oodz = oz * idz;

  // The stack keeps the newest kStackSize entries, like the plain path's
  // fixed-depth shift register: an overflowing push drops the oldest.
  int32_t stack[kStackSize];
  int top = 0;    // next free slot, mod kStackSize
  int depth = 0;  // live entries, <= kStackSize
  auto pop = [&]() -> int32_t {
    if (depth == 0) return kSentinel;
    --depth;
    top = (top + kStackSize - 1) % kStackSize;
    return stack[top];
  };

  float hit_t = tmax;
  int32_t hit_slot = -1;
  int32_t cur = 0;

  while (cur != kSentinel) {
    // ---- inner nodes ----
    while (cur >= 0 && cur != kSentinel) {
      const float4* r = rows + 4 * static_cast<int64_t>(cur);
      const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2),
                   m = __ldg(r + 3);
      const float c0lox = a.x * idx - oodx, c0hix = a.y * idx - oodx;
      const float c0loy = a.z * idy - oody, c0hiy = a.w * idy - oody;
      const float c1lox = b.x * idx - oodx, c1hix = b.y * idx - oodx;
      const float c1loy = b.z * idy - oody, c1hiy = b.w * idy - oody;
      const float c0loz = c.x * idz - oodz, c0hiz = c.y * idz - oodz;
      const float c1loz = c.z * idz - oodz, c1hiz = c.w * idz - oodz;
      const float c0min = max4(fminf(c0lox, c0hix), fminf(c0loy, c0hiy),
                               fminf(c0loz, c0hiz), tmin);
      const float c0max = min4(fmaxf(c0lox, c0hix), fmaxf(c0loy, c0hiy),
                               fmaxf(c0loz, c0hiz), hit_t);
      const float c1min = max4(fminf(c1lox, c1hix), fminf(c1loy, c1hiy),
                               fminf(c1loz, c1hiz), tmin);
      const float c1max = min4(fmaxf(c1lox, c1hix), fmaxf(c1loy, c1hiy),
                               fmaxf(c1loz, c1hiz), hit_t);
      const bool trav0 = c0min <= c0max;
      const bool trav1 = c1min <= c1max;
      const int32_t child0 = __float_as_int(m.x);
      const int32_t child1 = __float_as_int(m.y);
      if (trav0 && trav1) {
        const bool swap = c1min < c0min;
        cur = swap ? child1 : child0;
        stack[top] = swap ? child0 : child1;
        top = (top + 1) % kStackSize;
        depth = min(depth + 1, kStackSize);
      } else if (trav0) {
        cur = child0;
      } else if (trav1) {
        cur = child1;
      } else {
        cur = pop();
      }
    }
    // ---- leaf triangles (Woop unit-triangle test) ----
    while (cur < 0) {
      const float4* r = rows + 4 * static_cast<int64_t>(~cur);
      const float4 m0 = __ldg(r), m1 = __ldg(r + 1), m2 = __ldg(r + 2),
                   md = __ldg(r + 3);
      const float Oz = m0.w - ox * m0.x - oy * m0.y - oz * m0.z;
      const float invDz = 1.0f / (dx * m0.x + dy * m0.y + dz * m0.z);
      const float t = Oz * invDz;
      bool hit = false;
      if (t > tmin && t < hit_t) {
        const float Ox = m1.w + ox * m1.x + oy * m1.y + oz * m1.z;
        const float Dx = dx * m1.x + dy * m1.y + dz * m1.z;
        const float u = Ox + t * Dx;
        if (u >= 0.0f && u <= 1.0f) {
          const float Oy = m2.w + ox * m2.x + oy * m2.y + oz * m2.z;
          const float Dy = dx * m2.x + dy * m2.y + dz * m2.z;
          const float v = Oy + t * Dy;
          if (v >= 0.0f && u + v <= 1.0f) {
            hit = true;
            hit_t = t;
            hit_slot = __float_as_int(md.x);
          }
        }
      }
      if (kAnyHit && hit) {
        cur = kSentinel;
      } else if (__float_as_int(md.y) != 0) {
        cur = pop();
      } else {
        cur = cur - 1;  // ~(row + 1)
      }
    }
  }
  out_slot[i] = hit_slot;
  out_t[i] = hit_t;
}

// One thread per ray. (A persistent-threads variant, whose warps fetched 32
// rays at a time from a global atomic counter, measured within 3% of this
// launch on the H100 and was removed: see PERF.md.)
template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) trace_kernel(Rays p) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kBlock) + threadIdx.x;
  if (i < p.n) trace_ray<kAnyHit>(p, i);
}

ffi::Error TraceRaysImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> packed,
                         ffi::Buffer<ffi::F32> orig, ffi::Buffer<ffi::F32> dir,
                         ffi::Buffer<ffi::F32> tmin, ffi::Buffer<ffi::F32> tmax,
                         ffi::Buffer<ffi::PRED> active,
                         ffi::Buffer<ffi::S32> n_active,
                         ffi::ResultBuffer<ffi::S32> hit_slot,
                         ffi::ResultBuffer<ffi::F32> hit_t, int32_t anyhit) {
  const auto pdims = packed.dimensions();
  if (pdims.size() != 2 || pdims[1] != 16) {
    return ffi::Error::InvalidArgument("packed must be (K, 16) f32");
  }
  const int64_t n = orig.dimensions()[0];
  if (n == 0) return ffi::Error::Success();
  const Rays p{reinterpret_cast<const float4*>(packed.typed_data()),
               orig.typed_data(),
               dir.typed_data(),
               tmin.typed_data(),
               tmax.typed_data(),
               active.typed_data(),
               n_active.typed_data(),
               n,
               hit_slot->typed_data(),
               hit_t->typed_data()};
  const int64_t grid = (n + kBlock - 1) / kBlock;
  if (anyhit) {
    trace_kernel<true><<<grid, kBlock, 0, stream>>>(p);
  } else {
    trace_kernel<false><<<grid, kBlock, 0, stream>>>(p);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    TptTraceRays, TraceRaysImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()   // packed
        .Arg<ffi::Buffer<ffi::F32>>()   // orig
        .Arg<ffi::Buffer<ffi::F32>>()   // dir
        .Arg<ffi::Buffer<ffi::F32>>()   // tmin
        .Arg<ffi::Buffer<ffi::F32>>()   // tmax
        .Arg<ffi::Buffer<ffi::PRED>>()  // active
        .Arg<ffi::Buffer<ffi::S32>>()   // n_active
        .Ret<ffi::Buffer<ffi::S32>>()   // hit_slot
        .Ret<ffi::Buffer<ffi::F32>>()   // hit_t
        .Attr<int32_t>("anyhit"));
