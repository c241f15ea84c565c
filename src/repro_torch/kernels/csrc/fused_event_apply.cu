// One K-event server apply on one flat parameter leaf, in one launch.
//
// Replaces the TPU kernel
// `repro/kernels/fused_event_apply.py::fused_event_apply_2d` (Pallas body
// `_kernel`).  Per element:
//
//   ḡ  = Σ_k wmean_k g_k                   (k = 0..K-1 in order)
//   n', b', v' by eqs. 4-6 against ḡ, held at n, b, v when has_push == 0,
//                and passed through unchanged when track_stats is off
//   Δ  = Σ_k w_k g_k                        ('coeff' mode)
//      | Σ_k w_k · lr / (v' τ_k + ε) · g_k  ('fasgd' mode, post-stats v')
//   θ' = θ - Δ
//
// Both sums run k = 0..K-1 in order, as the TPU kernel's two fori_loops do.
//
// Bound: bytes.  Each element reads θ, n, b, v and its K gradients and
// writes θ', n', b', v': (K + 8)·4 B per element with θ in fp32, 544 B at
// K = 128 (86.5 MB per window for the 784-200-10 MLP, about 26 us at
// 3.35 TB/s).  The TPU kernel keeps the K gradient tiles resident in VMEM
// and reads them twice from there.  This first, simple kernel (one thread
// per element, grid-stride loop) reads them twice from global memory
// instead: at K = 128 the w0 gradients are 80 MB, above the 50 MB L2, so
// with track_stats on the second pass rereads device memory and moves
// about (2K + 8)·4 B per element.  Staging the K gradient tiles in shared
// memory so each is read once is the planned redesign.
//
// w, wmean and τ are [K] device vectors and has_push a device scalar: they
// are computed on the device from the gates and timestamps, so the host
// never waits for them.  lr and the constants go by value.  θ and g are
// fp32 or bf16 (template); the statistics are fp32.  Built with
// -fmad=false, as fasgd_update.cu is.

#include "common.cuh"

namespace {

using repro::Consts;
using repro::kThreads;
using repro::load_f;
using repro::store_f;

template <typename T, bool kFasgd, bool kTrack, bool kLiteral>
__global__ void __launch_bounds__(kThreads)
fused_event_apply_kernel(const T* __restrict__ p, const T* __restrict__ g,
                         const float* __restrict__ n,
                         const float* __restrict__ b,
                         const float* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ wmean,
                         const float* __restrict__ tau,
                         const float* __restrict__ has_push_ptr, Consts c,
                         int num_events, int64_t size, T* __restrict__ po,
                         float* __restrict__ no, float* __restrict__ bo,
                         float* __restrict__ vo) {
  const bool has_push = *has_push_ptr > 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < size; i += stride) {
    const float n0 = n[i], b0 = b[i], v0 = v[i];
    float n1 = n0, b1 = b0, v1 = v0;
    if (kTrack) {
      float gbar = 0.0f;
      for (int k = 0; k < num_events; ++k) {
        gbar += __ldg(wmean + k) * load_f(g, static_cast<int64_t>(k) * size + i);
      }
      const float nn = c.gamma * n0 + c.one_minus_gamma * gbar * gbar;
      const float bb = c.gamma * b0 + c.one_minus_gamma * gbar;
      const float sd = sqrtf(fmaxf(nn - bb * bb, 0.0f) + c.eps);
      const float vv = kLiteral ? c.beta * v0 + c.one_minus_beta / sd
                                : c.beta * v0 + c.one_minus_beta * sd;
      if (has_push) {
        n1 = nn;
        b1 = bb;
        v1 = vv;
      }
    }
    float acc = 0.0f;
    for (int k = 0; k < num_events; ++k) {
      const float gk = load_f(g, static_cast<int64_t>(k) * size + i);
      if (kFasgd) {
        const float scale = c.lr / (v1 * __ldg(tau + k) + c.eps);
        acc += __ldg(w + k) * scale * gk;
      } else {
        acc += __ldg(w + k) * gk;
      }
    }
    store_f(po, i, load_f(p, i) - acc);
    no[i] = n1;
    bo[i] = b1;
    vo[i] = v1;
  }
}

struct Args {
  const void* p;
  const void* g;
  const float *n, *b, *v, *w, *wmean, *tau, *has_push;
  Consts c;
  int num_events;
  int64_t size;
  void* po;
  float *no, *bo, *vo;
};

template <typename T, bool kFasgd, bool kTrack, bool kLiteral>
void launch_one(const Args& a, dim3 grid, cudaStream_t stream) {
  fused_event_apply_kernel<T, kFasgd, kTrack, kLiteral>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(a.p), static_cast<const T*>(a.g), a.n, a.b,
          a.v, a.w, a.wmean, a.tau, a.has_push, a.c, a.num_events, a.size,
          static_cast<T*>(a.po), a.no, a.bo, a.vo);
}

template <typename T>
void launch(const Args& a, int fasgd, int track, int literal, dim3 grid,
            cudaStream_t s) {
  if (fasgd) {
    if (track) {
      literal ? launch_one<T, true, true, true>(a, grid, s)
              : launch_one<T, true, true, false>(a, grid, s);
    } else {
      launch_one<T, true, false, false>(a, grid, s);
    }
  } else {
    if (track) {
      literal ? launch_one<T, false, true, true>(a, grid, s)
              : launch_one<T, false, true, false>(a, grid, s);
    } else {
      launch_one<T, false, false, false>(a, grid, s);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (θ and g).  mode_fasgd: 1 = 'fasgd',
// 0 = 'coeff'.  g is [num_events, size], contiguous.  Returns
// cudaGetLastError().
extern "C" int repro_fused_event_apply(
    int dtype, int mode_fasgd, int track_stats, int literal, const void* p,
    const void* g, const void* n, const void* b, const void* v, const void* w,
    const void* wmean, const void* tau, const void* has_push, float lr,
    float gamma, float one_minus_gamma, float beta, float one_minus_beta,
    float eps, int num_events, int64_t size, void* po, void* no, void* bo,
    void* vo, void* stream) {
  Args a;
  a.p = p;
  a.g = g;
  a.n = static_cast<const float*>(n);
  a.b = static_cast<const float*>(b);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.wmean = static_cast<const float*>(wmean);
  a.tau = static_cast<const float*>(tau);
  a.has_push = static_cast<const float*>(has_push);
  a.c = Consts{lr, gamma, one_minus_gamma, beta, one_minus_beta, eps};
  a.num_events = num_events;
  a.size = size;
  a.po = po;
  a.no = static_cast<float*>(no);
  a.bo = static_cast<float*>(bo);
  a.vo = static_cast<float*>(vo);
  const dim3 grid = repro::grid_for(size);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, mode_fasgd, track_stats, literal, grid, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(a, mode_fasgd, track_stats, literal, grid, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
