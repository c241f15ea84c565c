// Exact softmax attention, blockwise with an online softmax (flash
// attention), for GQA with causal and sliding-window masks.
//
// Replaces the TPU kernel `repro/kernels/flash_attention.py::flash_attention`
// (Pallas body `_kernel`).  What it computes is the same:
//
//   o = softmax(q·kᵀ·sm_scale + mask)·v         q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D]
//
// q head h reads kv head h / (Hq/Hkv); the queries sit at positions
// Lk-Lq … Lk-1 of the kv axis; key j is visible to a query at position i
// when j < Lk, j <= i (causal) and j > i - window (window > 0); a row with
// no visible key outputs 0.  Scores, the running max m, the running sum l
// and the accumulator are float32; o is stored in q's dtype (fp32 or bf16).
//
// What differs from the TPU kernel, and why:
// - The TPU walks the kv axis as the innermost, sequential grid dimension and
//   carries (m, l, acc) in VMEM scratch between grid steps.  Hopper's blocks
//   run in parallel in no order, so one thread block owns a (batch, q head,
//   q block) and loops over the kv blocks itself; m, l and acc live in
//   registers for the whole loop and never touch device memory.
// - The TPU skips a fully masked kv block with `pl.when` but still spends
//   its grid step.  Here the loop bounds prune it: kv blocks run up to the
//   block's last query when causal (half a causal prefill's work) and start
//   at its first query's window when windowed.  Causal q blocks are
//   scheduled longest first.
// - The TPU pads q/k/v to block multiples with copies.  Here the tails are
//   masked in the kernel, and every tensor comes with its own batch, head
//   and sequence strides (the last dimension must be contiguous), so the
//   model passes permuted views of its [B, S, H, D] activations and of its
//   cache slots with no pad or transpose copies.
//
// Two kernels, picked by Lq:
// - `flash_tile_kernel` (prefill, Lq > kRowsMaxLq): 128 threads own a 64-query
//   block; each 64-key tile of K and V is staged in shared memory as fp32
//   (rows padded by one float, so the column walks are free of bank
//   conflicts).  A thread computes a 4 x 8 patch of the score tile (rows
//   rg + 16i, keys cg + 8j) with CUDA-core fp32 FMAs, reduces the row max and
//   sum across the 8 threads that share its rows with warp shuffles, writes
//   its probabilities to shared memory, and accumulates rows rg + 16i, dims
//   cg + 8j of p·v.
// - `flash_rows_kernel` (decode, Lq <= kRowsMaxLq): one block of 16 warps
//   per (batch, q head, query).  The visible keys are split into 16
//   contiguous chunks, one per warp; a lane holds D/32 dims of q, each score
//   is a warp shuffle reduction, 8 keys' K and V loads in flight at a time;
//   the warps' (m, l, acc) are merged in shared memory at the end.  At the
//   main path's decode shape there are only B·Hq = 128 blocks for 132 SMs,
//   so the warps of one block are all the latency hiding an SM gets.  Each q head
//   reads its kv head's keys itself: the 8 q heads of a GQA group read the
//   same K/V (through L2), which a later kernel should share.
//
// Bound, at the main path's shapes (tinyllama-1.1b, bf16, B=4, Hq=32, Hkv=4,
// D=64, on an H100 at 989 TFLOP/s bf16 and 3.35 TB/s):
// - causal prefill, Lq = Lk = 2048: 4·B·Hq·L²·D/2 = 68.7 GFLOP against
//   75.5 MB of q/k/v/o, so operations bound it (69.5 us at the tensor-core
//   rate).  This kernel does its products on the CUDA cores in fp32 (67
//   TFLOP/s peak), so it cannot come near that bound; tensor cores (mma.sync
//   or wgmma on bf16 tiles, fp32 accumulation) are a later PR's work.
// - decode, Lq = 1 over ~2048 cached keys: about 8.4 MB of K/V per layer,
//   so bytes bound it (2.5 us); the kernel reads each K/V row once per q
//   head, eight times per kv head, and leans on L2 for the repeats.
//
// Built with FMA contraction on (kernels/build.py gives this source no
// -fmad=false): every product here is a well-conditioned sum of products or
// of positive weights, the plain version's cuBLAS products contract too, and
// the kernel is bound by its operations, so separate roundings would only
// halve its rate.  Exponentials use expf, not the approximate __expf.

#include "common.cuh"

namespace {

using repro::load_f;
using repro::store_f;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: finite, so
                                   // m_prev - m_new is never inf - inf
constexpr int kBQ = 64;            // queries per tile block
constexpr int kBK = 64;            // keys per kv tile
constexpr int kTileThreads = 128;
constexpr int kRowThreads = 512;   // 16 warps
constexpr int kRowsMaxLq = 16;     // Lq up to this takes the rows kernel
constexpr int kKeysInFlight = 8;
constexpr unsigned kFull = 0xffffffffu;

// Element strides of one tensor: batch, head, sequence (dim is contiguous).
struct Strides3 {
  int64_t b, h, l;
};

struct Problem {
  int B, Hq, Hkv, Lq, Lk, group, causal, window;
  float scale;
  Strides3 q, k, v, o;
};

__device__ __forceinline__ bool visible(int kpos, int qpos, int Lk, int causal,
                                        int window) {
  return kpos < Lk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// The keys [*begin, *end) that some query in [q_lo, q_hi] may see.
__device__ __forceinline__ void kv_range(const Problem& p, int q_lo, int q_hi,
                                         int* begin, int* end) {
  int e = p.causal ? min(p.Lk, q_hi + 1) : p.Lk;
  int b = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  *begin = b;
  *end = max(e, b);
}

template <int D>
constexpr int tile_smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kTileThreads)
flash_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, Problem p) {
  constexpr int QS = D + 1;    // padded row stride of Q, K and V tiles
  constexpr int PS = kBK + 1;  // padded row stride of the probability tile
  constexpr int RI = kBQ / 16; // rows per thread
  constexpr int CJ = kBK / 8;  // keys per thread
  constexpr int DJ = D / 8;    // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * QS;

  const int nqb = (p.Lq + kBQ - 1) / kBQ;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / p.group;
  const T* qp = q + b * p.q.b + h * p.q.h;
  const T* kp = k + b * p.k.b + kvh * p.k.h;
  const T* vp = v + b * p.v.b + kvh * p.v.h;
  T* op = o + b * p.o.b + h * p.o.h;

  const int tid = threadIdx.x;
  const int rg = tid / 8;  // this thread's rows: rg + 16 i
  const int cg = tid % 8;  // its keys cg + 8 j, and its output dims cg + 8 j
  const int q0 = qb * kBQ;
  const int q_offset = p.Lk - p.Lq;

  for (int idx = tid; idx < kBQ * D; idx += kTileThreads) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    Qs[r * QS + c] = qi < p.Lq ? load_f(qp, qi * p.q.l + c) : 0.0f;
  }

  float m[RI], l[RI], acc[RI][DJ];
  int qpos[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
    qpos[i] = q0 + rg + 16 * i + q_offset;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  int kv_begin, kv_end;
  kv_range(p, q0 + q_offset, min(q0 + kBQ, p.Lq) - 1 + q_offset, &kv_begin,
           &kv_end);
  for (int kb = kv_begin / kBK * kBK; kb < kv_end; kb += kBK) {
    __syncthreads();  // the last tile's readers are done (Q stored, 1st pass)
    for (int idx = tid; idx < kBK * D; idx += kTileThreads) {
      const int r = idx / D, c = idx % D;
      const int kk = kb + r;
      const bool in = kk < p.Lk;
      Ks[r * QS + c] = in ? load_f(kp, kk * p.k.l + c) : 0.0f;
      Vs[r * QS + c] = in ? load_f(vp, kk * p.v.l + c) : 0.0f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(rg + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(cg + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const bool vis = visible(kb + cg + 8 * j, qpos[i], p.Lk, p.causal,
                                 p.window);
        s[i][j] = vis ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads that share these rows are lanes cg = 0..7 of a warp
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const bool vis = visible(kb + cg + 8 * j, qpos[i], p.Lk, p.causal,
                                 p.window);
        const float pr = vis ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(rg + 16 * i) * PS + cg + 8 * j] = pr;
        sum += pr;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      sum += __shfl_xor_sync(kFull, sum, 4);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int jk = 0; jk < kBK; ++jk) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(rg + 16 * i) * PS + jk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[jk * QS + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= p.Lq) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store_f(op, qi * p.o.l + cg + 8 * j, acc[i][j] / li);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kRowThreads)
flash_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, Problem p) {
  constexpr int U = D / 32;        // dims per lane: lane + 32 u
  constexpr int W = kRowThreads / 32;
  constexpr int G = kKeysInFlight;
  __shared__ float sm_m[W], sm_l[W], sm_acc[W][D];

  const int qi = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / p.group;
  const T* qp = q + b * p.q.b + h * p.q.h + qi * p.q.l;
  const T* kp = k + b * p.k.b + kvh * p.k.h;
  const T* vp = v + b * p.v.b + kvh * p.v.h;
  T* op = o + b * p.o.b + h * p.o.h + qi * p.o.l;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;

  const int qpos = qi + p.Lk - p.Lq;
  int kv_begin, kv_end;
  kv_range(p, qpos, qpos, &kv_begin, &kv_end);
  // every key of [kv_begin, kv_end) is visible to this query
  const int chunk = (kv_end - kv_begin + W - 1) / W;
  const int lo = kv_begin + w * chunk;
  const int hi = min(lo + chunk, kv_end);

  float qv[U], acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    qv[u] = load_f(qp, lane + 32 * u);
    acc[u] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;
  for (int j0 = lo; j0 < hi; j0 += G) {
    // all of the group's K and V loads in flight at once
    float kx[G][U], vx[G][U];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const bool in = j0 + g < hi;  // uniform across the warp
#pragma unroll
      for (int u = 0; u < U; ++u) {
        kx[g][u] = in ? load_f(kp, (j0 + g) * p.k.l + lane + 32 * u) : 0.0f;
        vx[g][u] = in ? load_f(vp, (j0 + g) * p.v.l + lane + 32 * u) : 0.0f;
      }
    }
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) part += qv[u] * kx[g][u];
      s[g] = part;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(kFull, s[g], off);
    float mx = kNegInf;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] = j0 + g < hi ? s[g] * p.scale : kNegInf;
      mx = fmaxf(mx, s[g]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float pr[G], sum = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      pr[g] = j0 + g < hi ? expf(s[g] - m_new) : 0.0f;
      sum += pr[g];
    }
    l = corr * l + sum;
    m = m_new;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float a = acc[u] * corr;
#pragma unroll
      for (int g = 0; g < G; ++g) a += pr[g] * vx[g][u];
      acc[u] = a;
    }
  }

  if (lane == 0) {
    sm_m[w] = m;
    sm_l[w] = l;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) sm_acc[w][lane + 32 * u] = acc[u];
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mm = kNegInf;
#pragma unroll
    for (int x = 0; x < W; ++x) mm = fmaxf(mm, sm_m[x]);
    float ll = 0.0f, out = 0.0f;
#pragma unroll
    for (int x = 0; x < W; ++x) {
      const float wt = expf(sm_m[x] - mm);
      ll += sm_l[x] * wt;
      out += sm_acc[x][d] * wt;
    }
    store_f(op, d, out / (ll == 0.0f ? 1.0f : ll));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Problem& p, cudaStream_t stream) {
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  auto* ot = static_cast<T*>(o);
  if (p.Lq <= kRowsMaxLq) {
    flash_rows_kernel<T, D><<<dim3(p.Lq, p.Hq, p.B), kRowThreads, 0,
                              stream>>>(qt, kt, vt, ot, p);
  } else {
    constexpr int smem = tile_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tile_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const int nqb = (p.Lq + kBQ - 1) / kBQ;
    flash_tile_kernel<T, D><<<dim3(nqb, p.Hq, p.B), kTileThreads, smem,
                              stream>>>(qt, kt, vt, ot, p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k,
                       const void* v, void* o, const Problem& p,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, p, stream);
    case 64: return launch<T, 64>(q, k, v, o, p, stream);
    case 128: return launch<T, 128>(q, k, v, o, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); head_dim in
// {32, 64, 128}.  `strides` (host memory) holds the batch, head and sequence
// element strides of q, k, v and o, in that order (12 values).  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(int dtype, int head_dim, const void* q,
                                     const void* k, const void* v, void* o,
                                     int B, int Hq, int Hkv, int Lq, int Lk,
                                     const int64_t* strides, int causal,
                                     int window, float sm_scale,
                                     void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Lq < 1 || Lk < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Lq = Lq;
  p.Lk = Lk;
  p.group = Hq / Hkv;
  p.causal = causal;
  p.window = window;
  p.scale = sm_scale;
  Strides3* dst[4] = {&p.q, &p.k, &p.v, &p.o};
  for (int t = 0; t < 4; ++t)
    *dst[t] = Strides3{strides[3 * t], strides[3 * t + 1],
                       strides[3 * t + 2]};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dim<float>(head_dim, q, k, v, o, p, s);
  } else if (dtype == 1) {
    err = launch_dim<__nv_bfloat16>(head_dim, q, k, v, o, p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
