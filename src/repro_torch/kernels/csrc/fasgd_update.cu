// One FASGD server push (paper eqs. 4-8) on one flat parameter leaf.
//
// Replaces the TPU kernel `repro/kernels/fasgd_update.py::fasgd_update_2d`
// (Pallas body `_kernel`), which works on (R, 128) tiles padded to the
// TPU's (8, 128) vregs.  Here each leaf is taken flat and contiguous, of any
// length, and the grid-stride loop masks the tail, so the wrapper makes no
// pad or unpad copies.
//
//   n' = γ n + (1-γ) g²                                   (eq. 4)
//   b' = γ b + (1-γ) g                                    (eq. 5)
//   s  = sqrt(max(n' - b'², 0) + ε)
//   v' = β v + (1-β) s     ('intent')  |  β v + (1-β)/s  ('literal')   (eq. 6)
//   θ' = θ - lr / (v' τ + ε) · g                          (eqs. 7-8)
//
// Bound: bytes.  Each element reads θ, g, n, b, v and writes θ', n', b', v':
// 36 B per element with θ in fp32 (5.72 MB for the 784-200-10 MLP, about
// 1.7 us at 3.35 TB/s), against some 20 flops.  The design does nothing
// more than touch each byte once, coalesced (neighbouring threads on
// neighbouring elements), with every intermediate in registers.  At this
// model one push is far below the launch cost of its four leaf launches;
// fusing the leaves into one launch or capturing the event loop in a CUDA
// graph is later work.
//
// τ arrives as a device pointer (it is computed on the device from the
// timestamps), so the host never waits for it; lr and the constants go by
// value.  θ and g are fp32 or bf16 (template); the statistics are fp32.
//
// Built with -fmad=false (kernels/build.py): the operations round one by
// one in the plain version's order, so the kernel agrees with it to the
// last bit or two even where the literal variant's v is ill-conditioned.

#include "common.cuh"

namespace {

using repro::Consts;
using repro::kThreads;
using repro::load_f;
using repro::store_f;

template <typename T, bool kLiteral>
__global__ void __launch_bounds__(kThreads)
fasgd_update_kernel(const T* __restrict__ p, const T* __restrict__ g,
                    const float* __restrict__ n, const float* __restrict__ b,
                    const float* __restrict__ v,
                    const float* __restrict__ tau_ptr, Consts c, int64_t size,
                    T* __restrict__ po, float* __restrict__ no,
                    float* __restrict__ bo, float* __restrict__ vo) {
  const float tau = *tau_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < size; i += stride) {
    const float gi = load_f(g, i);
    const float ni = c.gamma * n[i] + c.one_minus_gamma * gi * gi;
    const float bi = c.gamma * b[i] + c.one_minus_gamma * gi;
    const float sd = sqrtf(fmaxf(ni - bi * bi, 0.0f) + c.eps);
    const float vi = kLiteral ? c.beta * v[i] + c.one_minus_beta / sd
                              : c.beta * v[i] + c.one_minus_beta * sd;
    const float scale = c.lr / (vi * tau + c.eps);
    store_f(po, i, load_f(p, i) - scale * gi);
    no[i] = ni;
    bo[i] = bi;
    vo[i] = vi;
  }
}

template <typename T>
cudaError_t launch(int literal, const void* p, const void* g, const float* n,
                   const float* b, const float* v, const float* tau, Consts c,
                   int64_t size, void* po, float* no, float* bo, float* vo,
                   cudaStream_t stream) {
  const dim3 grid = repro::grid_for(size);
  if (literal) {
    fasgd_update_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(p), static_cast<const T*>(g), n, b, v, tau, c,
        size, static_cast<T*>(po), no, bo, vo);
  } else {
    fasgd_update_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(p), static_cast<const T*>(g), n, b, v, tau, c,
        size, static_cast<T*>(po), no, bo, vo);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (θ and g).  Returns cudaGetLastError().
extern "C" int repro_fasgd_update(int dtype, int literal, const void* p,
                                  const void* g, const void* n, const void* b,
                                  const void* v, const void* tau, float lr,
                                  float gamma, float one_minus_gamma,
                                  float beta, float one_minus_beta, float eps,
                                  int64_t size, void* po, void* no, void* bo,
                                  void* vo, void* stream) {
  const Consts c{lr, gamma, one_minus_gamma, beta, one_minus_beta, eps};
  const auto* nf = static_cast<const float*>(n);
  const auto* bf = static_cast<const float*>(b);
  const auto* vf = static_cast<const float*>(v);
  const auto* tf = static_cast<const float*>(tau);
  auto* nof = static_cast<float*>(no);
  auto* bof = static_cast<float*>(bo);
  auto* vof = static_cast<float*>(vo);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(literal, p, g, nf, bf, vf, tf, c, size, po, nof, bof,
                        vof, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(literal, p, g, nf, bf, vf, tf, c, size, po,
                                nof, bof, vof, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
