// Device helpers shared by the server-update kernels.
//
// θ and g are fp32 or bf16; every kernel computes in fp32 and loads and
// stores through these overloads.  The three server updates take a whole
// tree in one launch through a LeafTable: each block owns one tile of one
// leaf.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16(x);  // round to nearest even, like .to(bfloat16)
}

// V (2 or 4) consecutive elements from p + i as fp32: one 4·V-byte (fp32)
// or 2·V-byte (bf16) load.
__device__ __forceinline__ void load_vec(const float* p, int64_t i,
                                         float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p + i);
  o[0] = q.x;
  o[1] = q.y;
  o[2] = q.z;
  o[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, int64_t i,
                                         float (&o)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p + i);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}
__device__ __forceinline__ void load_vec(const float* p, int64_t i,
                                         float (&o)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p + i);
  o[0] = q.x;
  o[1] = q.y;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, int64_t i,
                                         float (&o)[2]) {
  const float2 q =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
  o[0] = q.x;
  o[1] = q.y;
}
__device__ __forceinline__ void store_vec(float* p, int64_t i,
                                          const float (&x)[4]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, int64_t i,
                                          const float (&x)[4]) {
  uint2 q;
  // round to nearest even, like .to(bfloat16)
  *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(x[0], x[1]);
  *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p + i) = q;
}
__device__ __forceinline__ void store_vec(float* p, int64_t i,
                                          const float (&x)[2]) {
  *reinterpret_cast<float2*>(p + i) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, int64_t i,
                                          const float (&x)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(x[0], x[1]);
}

// Elements i .. i+V-1 of p that lie below `size` (the rest read as 0): one
// vector load when `vec` (all V lie below `size` and p is aligned for it),
// else masked scalar loads.
template <typename T, int V>
__device__ __forceinline__ void loadn(const T* p, int64_t i, int64_t size,
                                      bool vec, float (&o)[V]) {
  if (vec) {
    load_vec(p, i, o);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = i + j < size ? load_f(p, i + j) : 0.0f;
  }
}
template <typename T, int V>
__device__ __forceinline__ void storen(T* p, int64_t i, int64_t size,
                                       bool vec, const float (&x)[V]) {
  if (vec) {
    store_vec(p, i, x);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (i + j < size) store_f(p, i + j, x[j]);
    }
  }
}

// The update's scalars, passed by value: lr and the eq. 4-6 constants.
struct Consts {
  float lr, gamma, one_minus_gamma, beta, one_minus_beta, eps;
};

constexpr int kThreads = 256;

// Up to kMaxLeaves flat leaves of one launch, passed by value as a kernel
// parameter (under the 4 KB limit).  ptr[l] holds leaf l's kPtrs pointers
// in the order its kernel names; first_block[l] is the first block of
// leaf l and first_block[num_leaves] the launch's block count.  The host
// side is `kernels/ops.py` (`_leaf_plan`, `_table`), which splits a longer
// tree into launches of kMaxLeaves leaves, one dtype each; its
// ctypes.Structure must match this layout byte for byte, which the loader
// checks against the entry point's `*_table_bytes`.
constexpr int kMaxLeaves = 32;

template <int kPtrs>
struct LeafTable {
  void* ptr[kMaxLeaves][kPtrs];
  int64_t size[kMaxLeaves];
  int64_t first_block[kMaxLeaves + 1];
  int32_t num_leaves;
  int32_t pad;
};

// The leaf that `block` belongs to: a linear search of the block starts,
// the same in every thread of the block.  The table must be a
// __grid_constant__ parameter: indexed at run time, an ordinary parameter
// would be copied to local memory first.
template <int kPtrs>
__device__ __forceinline__ int find_leaf(const LeafTable<kPtrs>& t,
                                         int64_t block) {
  int l = 0;
  while (l + 1 < t.num_leaves && block >= t.first_block[l + 1]) ++l;
  return l;
}

__host__ __device__ inline bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace repro
