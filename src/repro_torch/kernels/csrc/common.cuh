// Device helpers shared by the server-update kernels.
//
// θ and g are fp32 or bf16; every kernel computes in fp32 and loads and
// stores through these overloads.  Each kernel is a grid-stride loop of
// kThreads-thread blocks over one flat leaf, with the grid capped at a few
// resident blocks per SM (grid_for).

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

// The update's scalars, passed by value: lr and the eq. 4-6 constants.
struct Consts {
  float lr, gamma, one_minus_gamma, beta, one_minus_beta, eps;
};

constexpr int kThreads = 256;

// One block per kThreads elements, at most 16 blocks per SM of the H100's
// 132 (the grid-stride loop covers the rest), at least one block.
inline dim3 grid_for(int64_t size) {
  int64_t blocks = (size + kThreads - 1) / kThreads;
  const int64_t max_blocks = 132 * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  return dim3(static_cast<unsigned>(blocks));
}

}  // namespace repro
