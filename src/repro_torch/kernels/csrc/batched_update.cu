// A K-event weighted apply with no statistics on one flat parameter leaf.
//
// Replaces the TPU kernel
// `repro/kernels/batched_update.py::batched_scale_apply_2d` (Pallas body
// `_kernel`).  Per element:
//
//   w_k = m_k · c_k                   (c_k alone when there is no mask)
//   Δ   = Σ_k w_k · g_k                         ('coeff' mode)
//       | Σ_k w_k · lr / (v τ_k + ε) · g_k      ('fasgd' mode)
//   θ'  = θ - Δ
//
// The sum runs k = 0..K-1 in order from an fp32 zero, each term grouped as
// (w_k · scale_k) · g_k, as the TPU kernel's fori_loop does; θ and g are
// fp32 or bf16 (template), g is cast to fp32 before the product and θ' is
// rounded once.  Built with -fmad=false and IEEE division (no fast math):
// every multiply, add and division rounds on its own, as the plain
// version's separate elementwise ops do, so the two agree to the last bit.
//
// Bound: bytes.  Each element reads θ, v ('fasgd' only) and its K
// gradients once and writes θ' once: (K + 3)·4 B per element with θ in
// fp32, 83.32 MB for the 784-200-10 MLP at K = 128 (24.87 us at
// 3.35 TB/s), against some 6 operations per element and event (about
// 1.8 us at 67 TFLOP/s).  The TPU kernel tiles the leaf as (rows, 128)
// blocks and holds a [K, rows, 128] gradient block in VMEM; none of that
// is needed here.  The design:
//
// * each thread streams the K gradient rows of its elements once, 16 rows
//   loaded per round trip to memory (then 4, then 1 for the rest) and
//   summed in order, so the small leaves (one block or less) wait on K/16
//   round trips instead of K;
// * the K weights and τ values are staged in shared memory once per block,
//   as the TPU holds them in SMEM; 'coeff' mode stages no τ and never
//   loads v;
// * the accumulators stay in registers and θ' is written once;
// * how many consecutive elements a thread owns follows a comparison on
//   the card: in 'fasgd' mode 4, since each event's IEEE division adds a
//   long serial latency per thread and four independent ones overlap (one
//   element a thread was slower on every leaf of the MLP); in 'coeff' mode
//   1 below kWideMinSize elements, where the loads are the chain and four
//   times the threads keep more of them in flight, and 4 above it.  Four
//   elements go by one 16-byte (fp32) or 8-byte (bf16) vector load where
//   the leaf's length and pointers allow, else by masked scalar loads
//   (leaves of 10 elements exist).
//
// coeffs, taus and masks are [K] device vectors, so the host never waits
// for them; lr and ε go by value.  K is at most kMaxEvents, which the
// shared-memory staging needs; the wrapper checks it and so does the entry
// point.

#include "common.cuh"

namespace {

using repro::kThreads;
using repro::load_f;
using repro::store_f;

constexpr int kMaxEvents = 4096;   // w and τ: 32 KB of shared memory
// 'coeff' leaves shorter than this take one element a thread (see above).
constexpr int64_t kWideMinSize = int64_t{1} << 19;

// Four consecutive elements from p + i as fp32: one 16-byte (fp32) or
// 8-byte (bf16) load.
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

// The elements i .. i+V-1 of the row at p that lie below `size` (the rest
// read as 0), with one vector load when kVecLoads.
template <int V, bool kVecLoads, typename T>
__device__ __forceinline__ void load_group(const T* p, int64_t i, int64_t size,
                                           float (&o)[V]) {
  if constexpr (kVecLoads) {
    load_vec(p, i, o);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = i + j < size ? load_f(p, i + j) : 0.0f;
  }
}

template <int V, bool kVecLoads, typename T>
__device__ __forceinline__ void store_group(T* p, int64_t i, int64_t size,
                                            const float (&x)[V]) {
  if constexpr (kVecLoads) {
    store_vec(p, i, x);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (i + j < size) store_f(p, i + j, x[j]);
    }
  }
}

// acc += w · scale(v, τ) · g for one event, element by element.
template <int V, bool kFasgd>
__device__ __forceinline__ void accumulate(float (&acc)[V],
                                           const float (&g)[V],
                                           const float (&v)[V], float w,
                                           float tau, float lr, float eps) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (kFasgd) {
      const float scale = lr / (v[j] * tau + eps);   // eq. 7, per event
      acc[j] = acc[j] + w * scale * g[j];
    } else {
      acc[j] = acc[j] + w * g[j];
    }
  }
}

// Rows k .. k+C-1 of the thread's elements: all C loaded, then summed in
// order into acc.
template <int C, int V, bool kFasgd, bool kVecLoads, typename T>
__device__ __forceinline__ void sum_rows(const T* g, int k, int64_t i,
                                         int64_t size, const float* w_s,
                                         const float* tau_s,
                                         const float (&v)[V], float lr,
                                         float eps, float (&acc)[V]) {
  float gk[C][V];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    load_group<V, kVecLoads>(g + static_cast<int64_t>(k + u) * size, i, size,
                             gk[u]);
  }
#pragma unroll
  for (int u = 0; u < C; ++u) {
    accumulate<V, kFasgd>(acc, gk[u], v, w_s[k + u],
                          kFasgd ? tau_s[k + u] : 0.0f, lr, eps);
  }
}

// V elements a thread; kVecLoads (V = 4 only): size % 4 == 0 and every
// pointer aligned for the vector loads.
template <typename T, int V, bool kVecLoads, bool kFasgd, bool kMask>
__global__ void __launch_bounds__(kThreads)
batched_scale_apply_kernel(const T* __restrict__ p, const T* __restrict__ g,
                           const float* __restrict__ v,
                           const float* __restrict__ coeffs,
                           const float* __restrict__ taus,
                           const float* __restrict__ masks, float lr,
                           float eps, int num_events, int64_t size,
                           T* __restrict__ po) {
  extern __shared__ float staged[];   // w[K], then τ[K] in 'fasgd' mode
  float* w_s = staged;
  float* tau_s = staged + num_events;
  for (int k = threadIdx.x; k < num_events; k += blockDim.x) {
    w_s[k] = kMask ? masks[k] * coeffs[k] : coeffs[k];
    if (kFasgd) tau_s[k] = taus[k];
  }
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x * V;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * V;
       i < size; i += stride) {
    float vv[V] = {};
    if (kFasgd) load_group<V, kVecLoads>(v, i, size, vv);
    float acc[V] = {};
    int k = 0;
    for (; k + 16 <= num_events; k += 16) {
      sum_rows<16, V, kFasgd, kVecLoads>(g, k, i, size, w_s, tau_s, vv, lr,
                                         eps, acc);
    }
    for (; k + 4 <= num_events; k += 4) {
      sum_rows<4, V, kFasgd, kVecLoads>(g, k, i, size, w_s, tau_s, vv, lr,
                                        eps, acc);
    }
    for (; k < num_events; ++k) {
      sum_rows<1, V, kFasgd, kVecLoads>(g, k, i, size, w_s, tau_s, vv, lr,
                                        eps, acc);
    }
    float out[V];
    load_group<V, kVecLoads>(p, i, size, out);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = out[j] - acc[j];
    store_group<V, kVecLoads>(po, i, size, out);
  }
}

struct Args {
  const void* p;
  const void* g;
  const float *v, *coeffs, *taus, *masks;
  float lr, eps;
  int num_events;
  int64_t size;
  void* po;
};

template <typename T, int V, bool kVecLoads, bool kFasgd, bool kMask>
void launch_one(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * a.num_events * (kFasgd ? 2 : 1);
  batched_scale_apply_kernel<T, V, kVecLoads, kFasgd, kMask>
      <<<repro::grid_for((a.size + V - 1) / V), kThreads, smem, stream>>>(
          static_cast<const T*>(a.p), static_cast<const T*>(a.g), a.v,
          a.coeffs, a.taus, a.masks, a.lr, a.eps, a.num_events, a.size,
          static_cast<T*>(a.po));
}

template <typename T, int V, bool kVecLoads, bool kFasgd>
void launch(const Args& a, int has_mask, cudaStream_t s) {
  has_mask ? launch_one<T, V, kVecLoads, kFasgd, true>(a, s)
           : launch_one<T, V, kVecLoads, kFasgd, false>(a, s);
}

// 'fasgd' takes 4 elements a thread, with vector loads where `vec`;
// 'coeff' takes 4 with vector loads on long aligned leaves, else 1.
template <typename T>
void launch(const Args& a, int fasgd, int has_mask, bool vec, cudaStream_t s) {
  if (fasgd) {
    vec ? launch<T, 4, true, true>(a, has_mask, s)
        : launch<T, 4, false, true>(a, has_mask, s);
  } else if (vec && a.size >= kWideMinSize) {
    launch<T, 4, true, false>(a, has_mask, s);
  } else {
    launch<T, 1, false, false>(a, has_mask, s);
  }
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (θ and g).  mode_fasgd: 1 = 'fasgd',
// 0 = 'coeff' (v is then never read).  has_mask: 0 means masks is unused
// and w_k = c_k.  g is [num_events, size], contiguous.  Returns
// cudaErrorInvalidValue for an unknown dtype or num_events outside
// [1, kMaxEvents], else cudaGetLastError().
extern "C" int repro_batched_scale_apply(
    int dtype, int mode_fasgd, int has_mask, const void* p, const void* g,
    const void* v, const void* coeffs, const void* taus, const void* masks,
    float lr, float eps, int num_events, int64_t size, void* po,
    void* stream) {
  if (num_events < 1 || num_events > kMaxEvents || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.p = p;
  a.g = g;
  a.v = static_cast<const float*>(v);
  a.coeffs = static_cast<const float*>(coeffs);
  a.taus = static_cast<const float*>(taus);
  a.masks = static_cast<const float*>(masks);
  a.lr = lr;
  a.eps = eps;
  a.num_events = num_events;
  a.size = size;
  a.po = po;
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const size_t vbytes = 4 * elem;   // one vector load of θ or g
  const bool vec = size % 4 == 0 && aligned(p, vbytes) && aligned(g, vbytes) &&
                   aligned(po, vbytes) &&
                   (!mode_fasgd || aligned(v, 4 * sizeof(float)));
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, mode_fasgd, has_mask, vec, s);
  } else {
    launch<__nv_bfloat16>(a, mode_fasgd, has_mask, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
