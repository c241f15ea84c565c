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
//   run in parallel in no order, so a block loops over its kv tiles itself
//   with m, l and acc in registers (prefill), or the keys are split across
//   blocks and merged by a second launch (decode).
// - The TPU skips a fully masked kv block with `pl.when` but still spends
//   its grid step.  Here the loop bounds prune it: kv tiles run up to the
//   block's last query when causal (half a causal prefill's work) and start
//   at its first query's window when windowed.  Causal q blocks are
//   scheduled longest first.
// - The TPU pads q/k/v to block multiples with copies.  Here the tails are
//   masked in the kernel, and every tensor comes with its own batch, head
//   and sequence strides (the last dimension must be contiguous), so the
//   model passes permuted views of its [B, S, H, D] activations and of its
//   cache slots with no pad or transpose copies.
//
// Three kernels, picked by dtype and Lq (a dispatch, not a fallback: each
// input goes to exactly one of them, and a failed launch is returned):
// - `flash_wgmma_kernel` (bf16, Lq > kRowsMaxLq: prefill).  256 threads,
//   two warpgroups of 64 queries each, own a (batch, q head, 128-query
//   block); two blocks share an SM (128 registers a thread).  Q and a
//   two-stage ring of 64-key K and V tiles sit in shared memory as bf16 in
//   the 128-byte swizzled layout that `wgmma` descriptors read, filled by
//   16-byte `cp.async` copies (the next tile's copies fly while this tile
//   computes); a view whose base or strides are not 16-byte aligned is
//   copied element by element into the same layout.  S = Q·Kᵀ is `wgmma`
//   m64n64k16 from shared memory (K-major as K lies); the online softmax
//   runs on the accumulator fragment in registers (row max and sum across
//   the four lanes of a quad, one FFMA and one ex2.approx per element in
//   log2 units; masks only on the tiles at a mask's edge, a
//   warpgroup-uniform branch); O += P·V is `wgmma` m64nDk16 with P from
//   registers and V from shared memory through the transpose bit (V is
//   MN-major as it lies).  The head dim is padded in shared memory to DP,
//   the next multiple of 64 (64 for D = 32 and 64; two 64-column halves
//   for D = 80, 96, 112 and 128, zamba2-7b's shared attention at 112;
//   three parts for D = 192, deepseek-v2's MLA prefill), with zero
//   columns that no copy writes: S runs D/16 k16 steps
//   over the real columns only, P·V runs at nDP and only D output columns
//   are stored.  The padding lives in shared memory, so the host passes its
//   views as they are (no pad copy per call).  At D = 192, P·V is
//   m64n192k16 with 96 fp32 accumulators a thread, and Q (48 KB) with the
//   two-stage K/V ring (2 x 48 KB) takes 145 KB of shared memory: one block
//   an SM.
//   Why P is split: the plain version, like the TPU kernel, keeps P in fp32
//   through P·V, and bf16 outputs are held within one bf16 ulp of it.  P
//   rounded once to bf16 misses that by up to ~80x on near-zero outputs, so
//   P goes in as two bf16 parts, P_hi = P truncated to bf16 (its top 16
//   bits: integer ops, where a rounding conversion would queue on the
//   quarter-rate conversion pipe beside the exponentials) and P_lo =
//   bf16(P - P_hi), both accumulated into the same fp32 accumulator: P keeps
//   ~16 bits for a third product (tests/test_torch_attention.py emulates
//   both roundings).
//   What bounds it: not the tensor cores.  Each warpgroup runs S, then its
//   softmax, then P·V, waiting on each, and the SM's four warpgroups (two
//   blocks) overlap one another's phases; the softmax's exponentials and
//   integer work and the K/V tiles re-read from L2 by every q block set the
//   pace.  A producer warp with TMA and softmax/GEMM overlap inside a
//   warpgroup are the next steps.
// - `flash_tile_kernel` (fp32, Lq > kRowsMaxLq).  128 threads own a
//   64-query block; each 64-key tile of K and V is staged in shared memory
//   as fp32 (rows padded by one float against bank conflicts); products on
//   the CUDA cores in fp32.  TF32 tensor cores would miss the fp32
//   tolerance (1e-5).
// - `flash_decode_kernel` + `flash_decode_merge` (both dtypes, Lq <=
//   kRowsMaxLq: decode).  A block owns a (batch, kv head, key split) and
//   serves every q head of the GQA group and every query, so each K/V row
//   is read from device memory once per kv head.  Threads own keys: the
//   block copies its 128 keys' K and V rows into shared memory with
//   coalesced 16-byte `cp.async` copies, a thread takes its key's K row in
//   16-byte reads and computes that key's score for every (q head, query)
//   row; the rows' max, exponentials and sums are then taken once per key,
//   by a warp per row, and P·V runs with threads owning (row, 4 dims), D/4
//   threads a row (for D = 80 and 96 the block's last 8 threads own none,
//   for D = 112 the last 16, for D = 192 the last 32).
//   The keys are split across blocks (flash-decoding: at the main path's shape
//   B·Hkv = 16 groups for 132 SMs) into whole 128-key chunks, about two
//   blocks per SM; each split writes its (m, l, acc) to a scratch buffer
//   the wrapper allocates, and the merge launch rescales and sums them in
//   one round trip to L2.  The merge is a programmatic dependent launch
//   (griddepcontrol): its blocks are scheduled while the decode kernel runs
//   and wait for its end, so the second launch adds no launch gap.  fp32
//   math on the CUDA cores: decode is bound by bytes and latency, not
//   operations.
//
// Bound, at the main path's shapes (tinyllama-1.1b, bf16, B=4, Hq=32, Hkv=4,
// D=64, on an H100 at 989 TFLOP/s bf16 and 3.35 TB/s):
// - causal prefill, Lq = Lk = 2048: 4·B·Hq·L²·D/2 = 68.7 GFLOP against
//   75.5 MB of q/k/v/o, so operations bound it (69.5 us at the tensor-core
//   rate).  The split P makes the kernel's own work 1.5x that (~104 us).
// - decode, Lq = 1 over ~2048 cached keys: about 8.4 MB of K/V per layer,
//   so bytes bound it (2.5 us), read once per kv head.
//
// Built with FMA contraction on (kernels/build.py gives this source no
// -fmad=false): every product here is a well-conditioned sum of products or
// of positive weights, the plain version's cuBLAS products contract too, and
// the kernels are bound by operations or bytes, not by rounding.  The fp32
// and decode kernels use expf; the bf16 prefill kernel uses ex2.approx on
// scores scaled by log2(e), an error far below its outputs' bf16 ulp.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using repro::load_f;
using repro::store_f;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: finite, so
                                   // m_prev - m_new is never inf - inf
constexpr int kBQ = 64;            // queries per fp32 tile block
constexpr int kBK = 64;            // keys per kv tile (both prefill kernels)
constexpr int kTileThreads = 128;
constexpr int kRowsMaxLq = 16;     // Lq up to this takes the decode kernel
constexpr unsigned kFull = 0xffffffffu;

// Element strides of one tensor: batch, head, sequence (dim is contiguous).
struct Strides3 {
  int64_t b, h, l;
};

struct Problem {
  int B, Hq, Hkv, Lq, Lk, group, causal, window;
  int vec;  // 1 when every 16-byte piece of a q/k/v row is 16-byte aligned
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

// ---------------------------------------------------------------------------
// fp32 prefill: CUDA-core tiles

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

// ---------------------------------------------------------------------------
// bf16 prefill: wgmma

constexpr int kWgBQ = 128;         // queries per block: two warpgroups of 64
constexpr int kWgThreads = 256;
constexpr int kSwRow = 128;        // bytes of one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one block, for head dim D.  Every tile is stored
// as 64-column halves of kSwRow-byte rows; within each 1024-byte group of 8
// rows the 16-byte chunk c of row r sits at chunk c ^ (r % 8) (the 128-byte
// swizzle, which the wgmma descriptors below name with layout type 1).
template <int D>
struct WgLayout {
  static_assert(D % 16 == 0 && D <= 192, "head dim: a multiple of 16, <= 192");
  static constexpr int DP = (D + 63) / 64 * 64;  // padded head dim: 64, 128, 192
  static constexpr int NH = DP / 64;           // 64-column parts
  static constexpr int KS = D / 16;            // k16 steps of S = Q·Kᵀ
  static constexpr int Q_HALF = kWgBQ * kSwRow;
  static constexpr int KV_HALF = kBK * kSwRow;
  static constexpr int Q_BYTES = NH * Q_HALF;
  static constexpr int TILE_BYTES = NH * KV_HALF;   // one K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int STAGES = 2;             // the K/V ring
  static constexpr int USED = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = USED + 1024;      // + room to align to 1024
  // two blocks an SM where they fit in its registers (128 a thread)
  static constexpr int MIN_BLOCKS = NH == 1 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a swizzled (128-byte) tile at `p`: `lbo` is
// the byte stride between 64-column halves along M/N (MN-major operands
// only), `sbo` the byte stride between groups of 8 rows.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory writes before the async proxy's
// (wgmma's) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [base, base + ROWS) of a [*, D] bf16 matrix (row stride `ld`
// elements) into the swizzled tile at `dst` whose halves are `half` bytes
// apart; rows at or past `limit` are zero.  `vec`: 16-byte `cp.async`
// copies; else element loads and a 16-byte shared store.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, int half,
                                          const bf16* src, int64_t ld,
                                          int base, int limit, int vec) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  constexpr int N = ROWS * CH;
#pragma unroll
  for (int it = 0; it < (N + kWgThreads - 1) / kWgThreads; ++it) {
    const int idx = threadIdx.x + it * kWgThreads;
    if (N % kWgThreads != 0 && idx >= N) break;
    const int r = idx / CH, c = idx % CH;
    const int off = (c >> 3) * half + r * kSwRow + (((c & 7) ^ (r & 7)) << 4);
    const bool in = base + r < limit;
    const bf16* g = src + (in ? static_cast<int64_t>(base + r) * ld : 0) +
                    c * 8;
    if (vec) {
      cp_async16(smem_addr(dst + off), g, in ? 16 : 0);
    } else {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int x = 0; x < 8; ++x) e[x] = g[x];
      }
      *reinterpret_cast<uint4*>(dst + off) = val;
    }
  }
}

// 2^x, flushing subnormal results to 0 (they are below any P that counts)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[0..31] = A·B (scale_d = 0) or d + A·B (scale_d = 1): m64n64k16, A and
// B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..31] += A·B: m64n64k16, A from registers (4 bf16 pairs a
// thread), B from shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..63] += A·B: m64n128k16, A from registers (4 bf16 pairs a
// thread), B from shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..95] += A·B: m64n192k16, A from registers (4 bf16 pairs a
// thread), B from shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95}"
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n192(o, a, db);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, WgLayout<D>::MIN_BLOCKS)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   Problem p) {
  using L = WgLayout<D>;
  constexpr int NO = L::DP / 2;  // output accumulators a thread (n8 blocks x 4)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* ring = smem + L::Q_BYTES;

  const int nqb = (p.Lq + kWgBQ - 1) / kWgBQ;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / p.group;
  const bf16* qp = q + b * p.q.b + h * p.q.h;
  const bf16* kp = k + b * p.k.b + kvh * p.k.h;
  const bf16* vp = v + b * p.v.b + kvh * p.v.h;

  const int tid = threadIdx.x;
  const int wg = tid / 128;          // this warpgroup's 64 queries
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = qb * kWgBQ;
  const int q_offset = p.Lk - p.Lq;
  bf16* op = o + b * p.o.b + h * p.o.h;

  if (D != L::DP) {  // the padding columns stay zero: no copy writes them
    for (int i = tid; i < L::USED / 16; i += kWgThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  int kv_begin, kv_end;
  kv_range(p, q0 + q_offset, min(q0 + kWgBQ, p.Lq) - 1 + q_offset, &kv_begin,
           &kv_end);
  const int kb0 = kv_begin / kBK * kBK;
  const int ntiles = kv_end > kv_begin ? (kv_end - kb0 + kBK - 1) / kBK : 0;

  // the ring: tiles 0 .. STAGES-2 in flight before the loop, one group each
  // (Q travels with tile 0)
  load_tile<D, kWgBQ>(Qs, L::Q_HALF, qp, p.q.l, q0, p.Lq, p.vec);
#pragma unroll
  for (int st = 0; st < L::STAGES - 1; ++st) {
    if (st < ntiles) {
      uint8_t* dst = ring + st * L::STAGE_BYTES;
      load_tile<D, kBK>(dst, L::KV_HALF, kp, p.k.l, kb0 + st * kBK, p.Lk,
                        p.vec);
      load_tile<D, kBK>(dst + L::TILE_BYTES, L::KV_HALF, vp, p.v.l,
                        kb0 + st * kBK, p.Lk, p.vec);
    }
    cp_async_commit();
  }

  // This thread's two rows of the accumulator fragment: warp rows
  // 16·warp + lane/4 and that + 8; its columns are 8j + 2(lane%4) + {0, 1}.
  const int wq0 = q0 + wg * 64;
  const int row0 = wq0 + warp * 16 + lane / 4;
  const int qpos[2] = {row0 + q_offset, row0 + 8 + q_offset};
  const bool wg_idle = wq0 >= p.Lq;          // all 64 rows are padding
  const int wg_lo = wq0 + q_offset;
  const int wg_hi = min(wq0 + 63, p.Lq - 1) + q_offset;
  // the keys [klo[i], khi[i]] row i may see (row bounds of `visible`)
  int klo[2], khi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    khi[i] = p.causal ? min(qpos[i], p.Lk - 1) : p.Lk - 1;
    klo[i] = p.window > 0 ? qpos[i] - p.window + 1 : 0;
  }
  const int kcol = 2 * (lane % 4);  // this thread's first key in an n8 block
  const float sl2 = p.scale * kLog2e;  // scores to log2 units
  const uint8_t* Qw = Qs + wg * 64 * kSwRow;

  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < ntiles; ++t) {
    const int kb = kb0 + t * kBK;
    cp_async_wait<L::STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile t has landed; every reader of tile t-1 is done
    const int ahead = t + L::STAGES - 1;  // into the stage tile t-1 held
    if (ahead < ntiles) {
      uint8_t* nxt = ring + (ahead % L::STAGES) * L::STAGE_BYTES;
      load_tile<D, kBK>(nxt, L::KV_HALF, kp, p.k.l, kb0 + ahead * kBK, p.Lk,
                        p.vec);
      load_tile<D, kBK>(nxt + L::TILE_BYTES, L::KV_HALF, vp, p.v.l,
                        kb0 + ahead * kBK, p.Lk, p.vec);
    }
    cp_async_commit();
    // warpgroup-uniform: a tile this warpgroup's rows cannot see
    if (wg_idle || (p.causal && kb > wg_hi) ||
        (p.window > 0 && kb + kBK - 1 <= wg_lo - p.window))
      continue;
    const bool masked = kb + kBK > p.Lk || (p.causal && kb + kBK - 1 > wg_lo) ||
                        (p.window > 0 && kb <= wg_hi - p.window);
    const uint8_t* Ks = ring + (t % L::STAGES) * L::STAGE_BYTES;
    const uint8_t* Vs = Ks + L::TILE_BYTES;

    // S = Q·Kᵀ for this warpgroup's 64 rows and the tile's 64 keys
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < L::KS; ++ks) {  // the real columns only
      const uint64_t da =
          wg_desc(Qw + (ks >> 2) * L::Q_HALF + (ks & 3) * 32, 16, 1024);
      const uint64_t db =
          wg_desc(Ks + (ks >> 2) * L::KV_HALF + (ks & 3) * 32, 16, 1024);
      wgmma_ss_n64(s, da, db, ks > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence<32>(s);

    // online softmax on the fragment: m in score units, the exponentials
    // in log2 units (one FFMA and one ex2 an element)
    if (masked) {  // warpgroup-uniform: only tiles at a mask's edge
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = kb + kcol + 8 * j + c;
            if (key < klo[i] || key > khi[i]) s[4 * j + 2 * i + c] = kNegInf;
          }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          mx[i] = fmaxf(mx[i], s[4 * j + 2 * i + c]);
    float corr[2], msc[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = ex2((m[i] - m_new) * sl2);
      // a row that has seen no key yet: every x is kNegInf and gives 0
      msc[i] = m_new == kNegInf ? 0.0f : m_new * sl2;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          x = ex2(fmaf(x, sl2, -msc[i]));
          sum[i] += x;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
      sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
      l[i] = corr[i] * l[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        oacc[4 * j + 2 * i] *= corr[i];
        oacc[4 * j + 2 * i + 1] *= corr[i];
      }

    // P as two bf16 parts in the A-fragment layout (for keys 16kk..16kk+15,
    // registers (row g, keys 2q..), (g+8, 2q..), (g, 8+2q..), (g+8, 8+2q..)):
    // P_hi is P truncated to bf16 (its top 16 bits: integer ops, not the
    // conversion unit), P_lo = bf16(P - P_hi), so P keeps ~16 bits
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
        const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
        ph[kk][r] = __byte_perm(u0, u1, 0x7632);
        pl[kk][r] = pack_bf16(x0 - __uint_as_float(u0 & 0xffff0000u),
                              x1 - __uint_as_float(u1 & 0xffff0000u));
      }

    // O += P_hi·V + P_lo·V
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = wg_desc(Vs + kk * 16 * kSwRow, L::KV_HALF, 1024);
      wgmma_pv<L::DP>(oacc, ph[kk], db);
      wgmma_pv<L::DP>(oacc, pl[kk], db);
    }
    wg_commit();
    wg_wait_all();
    reg_fence<NO>(oacc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    if (qi >= p.Lq) continue;
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          oacc[4 * j + 2 * i] * inv, oacc[4 * j + 2 * i + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(
          op + qi * p.o.l + 8 * j + 2 * (lane % 4)) = val;
    }
  }
}

// ---------------------------------------------------------------------------
// decode: one block per (batch, kv head, key split), merged by a second launch

constexpr int kDecThreads = 128;
constexpr int kDecKeys = 128;         // keys per chunk: one a thread
constexpr int kDecOut = 4096;         // rows x D a block serves: 32 a thread
constexpr int kMaxSplits = 32;        // the wrapper sizes its scratch by this
constexpr int kDecTargetBlocks = 264; // about two blocks per SM of 132

// How the decode grid covers the problem: `hp` q heads of a group per block
// (`nrc` blocks cover a group), keys from `begin` in `nsplit` splits of
// `cps` chunks of kDecKeys.
struct DecodePlan {
  int hp, nrc, nsplit, cps, begin;
};

DecodePlan decode_plan(const Problem& p, int D) {
  DecodePlan d;
  d.hp = std::max(1, std::min(p.group, kDecOut / D / p.Lq));
  d.nrc = (p.group + d.hp - 1) / d.hp;
  // the first query's window start; every query sees keys up to Lk - 1 at most
  d.begin = p.window > 0 ? std::max(0, p.Lk - p.Lq - p.window + 1) : 0;
  const int nchunks = std::max(1, (p.Lk - d.begin + kDecKeys - 1) / kDecKeys);
  const int groups = p.B * p.Hkv * d.nrc;
  const int want = (kDecTargetBlocks + groups - 1) / groups;
  const int ns = std::max(1, std::min(want, std::min(kMaxSplits, nchunks)));
  d.cps = (nchunks + ns - 1) / ns;
  d.nsplit = (nchunks + d.cps - 1) / d.cps;
  return d;
}

// Shared memory of a decode block serving R rows: q [R][D], scores [R][C],
// m, l, corr [R] (float32), then the chunk's K rows at a pitch padded by 16
// bytes (so a thread's 16-byte reads of its own row are free of bank
// conflicts) and its V rows.
template <typename T, int D>
struct DecLayout {
  static constexpr int ROW = D * static_cast<int>(sizeof(T));  // bytes
  static constexpr int K_PITCH = ROW + 16;
  __host__ __device__ static constexpr int floats(int R) {
    return (R * D + R * kDecKeys + 3 * R + 3) / 4 * 4;
  }
  __host__ __device__ static constexpr int bytes(int R) {
    return 4 * floats(R) + kDecKeys * (K_PITCH + ROW);
  }
};

// 16 bytes of T as floats
__device__ __forceinline__ void unpack16(const uint4& u, float* f,
                                         const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f,
                                         const bf16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// 4 consecutive elements of T (8- or 16-byte aligned) as floats
__device__ __forceinline__ void load4(const float* src, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* src, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = c.x;
  f[3] = c.y;
}

// Rows [base, base + kDecKeys) of a [*, D] matrix of T (row stride `ld`
// elements) into shared memory at `pitch` bytes a row, coalesced 16-byte
// `cp.async` copies when `vec`, else element loads; rows at or past
// `limit` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, int pitch,
                                          const T* src, int64_t ld, int base,
                                          int limit, int vec) {
  constexpr int RB = D * static_cast<int>(sizeof(T)) / 16;
  constexpr int PER = 16 / static_cast<int>(sizeof(T));
  for (int idx = threadIdx.x; idx < kDecKeys * RB; idx += kDecThreads) {
    const int r = idx / RB, c = idx % RB;
    const bool in = base + r < limit;
    const T* g = src + (in ? static_cast<int64_t>(base + r) * ld : 0) +
                 c * PER;
    uint8_t* d = dst + r * pitch + c * 16;
    if (vec) {
      cp_async16(smem_addr(d), g, in ? 16 : 0);
    } else {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        T* e = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int x = 0; x < PER; ++x) e[x] = g[x];
      }
      *reinterpret_cast<uint4*>(d) = val;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part,
                    Problem p, DecodePlan pl) {
  using L = DecLayout<T, D>;
  constexpr int C = kDecKeys;
  constexpr int RB = L::ROW / 16;          // 16-byte pieces of a row
  constexpr int PER = 16 / static_cast<int>(sizeof(T));
  constexpr int TPR = D / 4;               // threads per output row
  constexpr int RP = kDecThreads / TPR;    // output rows per pass
  constexpr int NI = (kDecOut / D + RP - 1) / RP;  // passes: 8; 9 for D =
                                                   // 80, 96 and 112; 11
                                                   // for 192
  extern __shared__ float4 dsm4[];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / pl.nrc;
  const int h0 = kvh * p.group + (blockIdx.y % pl.nrc) * pl.hp;
  const int nh = min(pl.hp, (kvh + 1) * p.group - h0);
  const int64_t b = blockIdx.z;
  const int R = nh * p.Lq;  // rows: (q head, query), query fastest
  float* qs = reinterpret_cast<float*>(dsm4);
  float* ss = qs + R * D;
  float* ms = ss + R * C;
  float* ls = ms + R;
  float* cs = ls + R;
  uint8_t* ks = reinterpret_cast<uint8_t*>(qs + L::floats(R));
  uint8_t* vsb = ks + C * L::K_PITCH;
  const T* vs = reinterpret_cast<const T*>(vsb);
  const T* kp = k + b * p.k.b + kvh * p.k.h;
  const T* vp = v + b * p.v.b + kvh * p.v.h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_offset = p.Lk - p.Lq;
  const int lo = pl.begin + split * pl.cps * C;
  const int hi = min(lo + pl.cps * C, p.Lk);
  // the merge launch may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the first chunk's K and V fly while q is loaded
  load_rows<T, D>(ks, L::K_PITCH, kp, p.k.l, lo, hi, p.vec);
  load_rows<T, D>(vsb, L::ROW, vp, p.v.l, lo, hi, p.vec);
  cp_async_commit();
#pragma unroll 4
  for (int idx = tid; idx < R * D; idx += kDecThreads) {
    const int r = idx / D, d = idx % D;
    const int hh = h0 + r / p.Lq, qi = r % p.Lq;
    qs[idx] = load_f(q, b * p.q.b + hh * p.q.h + qi * p.q.l + d) * p.scale;
  }
  for (int r = tid; r < R; r += kDecThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.0f;
  }
  const int rq = tid / TPR, d0 = (tid % TPR) * 4;
  // this thread's rows; where TPR does not divide the block, the threads
  // past RP·TPR own none
  const int ni = rq < RP && rq < R ? (R - rq + RP - 1) / RP : 0;
  float acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int base = lo; base < hi; base += C) {
    const int n = min(C, hi - base);
    if (base > lo) {  // a later chunk: its rows replace the last one's
      load_rows<T, D>(ks, L::K_PITCH, kp, p.k.l, base, hi, p.vec);
      load_rows<T, D>(vsb, L::ROW, vp, p.v.l, base, hi, p.vec);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    // scores of this thread's key for every row
    if (tid < n) {
      const int j = base + tid;
      uint4 kr[RB];
#pragma unroll
      for (int x = 0; x < RB; ++x)
        kr[x] = reinterpret_cast<const uint4*>(ks + tid * L::K_PITCH)[x];
      for (int r = 0; r < R; ++r) {
        const int qpos = r % p.Lq + q_offset;
        const float4* qr = reinterpret_cast<const float4*>(qs + r * D);
        float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // four chains for ILP
#pragma unroll
        for (int x = 0; x < RB; ++x) {
          float kf[PER];
          unpack16(kr[x], kf, static_cast<const T*>(nullptr));
#pragma unroll
          for (int y = 0; y < PER; y += 4) {
            const float4 qv = qr[(x * PER + y) / 4];
            dot[0] += qv.x * kf[y];
            dot[1] += qv.y * kf[y + 1];
            dot[2] += qv.z * kf[y + 2];
            dot[3] += qv.w * kf[y + 3];
          }
        }
        ss[r * C + tid] = visible(j, qpos, p.Lk, p.causal, p.window)
                              ? (dot[0] + dot[1]) + (dot[2] + dot[3])
                              : kNegInf;
      }
    }
    __syncthreads();
    // the rows' max, exponentials and sums: a warp per row
    for (int r = warp; r < R; r += kDecThreads / 32) {
      float* sr = ss + r * C;
      float mx = kNegInf;
      for (int x = lane; x < n; x += 32) mx = fmaxf(mx, sr[x]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int x = lane; x < n; x += 32) {
        const float pr = sr[x] == kNegInf ? 0.0f : expf(sr[x] - m_new);
        sr[x] = pr;
        sum += pr;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[r] = corr;
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    // acc[row][d0..d0+3] = acc·corr + Σ_key p·v, row by row
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (i < ni) {
        const int r = rq + RP * i;
        const float* pr = ss + r * C;
        const float corr = cs[r];
        float a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = acc[i][e] * corr;
#pragma unroll 8
        for (int x = 0; x < n; ++x) {
          float vf[4];
          load4(vs + x * D + d0, vf);
          const float w = pr[x];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] += w * vf[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = a[e];
      }
    }
    __syncthreads();  // before the next chunk overwrites K, V and scores
  }

  // this split's (m, l) and unnormalised acc of each row, for the merge
  const int64_t rows = static_cast<int64_t>(p.B) * p.Hq * p.Lq;
  float* part_acc = part + rows * pl.nsplit * 2;
  const int64_t grow0 = (b * p.Hq + h0) * p.Lq;  // the block's first row
  for (int r = tid; r < R; r += kDecThreads) {
    part[((grow0 + r) * pl.nsplit + split) * 2] = ms[r];
    part[((grow0 + r) * pl.nsplit + split) * 2 + 1] = ls[r];
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if (i < ni) {
      const int r = rq + RP * i;
      *reinterpret_cast<float4*>(part_acc +
                                 ((grow0 + r) * pl.nsplit + split) * D + d0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// One block of D threads per output row: o = Σ_s acc_s·e^(m_s - M) /
// Σ_s l_s·e^(m_s - M), 0 where no split saw a key.  Launched as a
// programmatic dependent of the decode kernel: its blocks may start while
// that kernel runs and wait here until its partials are complete.
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_merge(const float* __restrict__ part, T* __restrict__ o,
                   Problem p, int nsplit) {
  __shared__ float wm[kMaxSplits], wl[kMaxSplits];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int64_t grow = blockIdx.x;
  const int d = threadIdx.x;
  const int64_t rows = static_cast<int64_t>(p.B) * p.Hq * p.Lq;
  const float* ml = part + grow * nsplit * 2;
  const float* acc = part + rows * nsplit * 2 + grow * nsplit * D;
  // one round trip: every split's (m, l), one a thread (D >= 32 >=
  // kMaxSplits), and this thread's accumulators of every split
  float a[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    a[s] = s < nsplit ? acc[s * D + d] : 0.0f;
  if (d < nsplit) {
    wm[d] = ml[2 * d];
    wl[d] = ml[2 * d + 1];
  }
  __syncthreads();
  float mm = kNegInf;
  for (int s = 0; s < nsplit; ++s) mm = fmaxf(mm, wm[s]);
  float ll = 0.0f, out = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < nsplit) {
      const float w = expf(wm[s] - mm);
      ll += wl[s] * w;
      out += a[s] * w;
    }
  }
  const int qi = static_cast<int>(grow % p.Lq);
  const int h = static_cast<int>((grow / p.Lq) % p.Hq);
  const int64_t b = grow / (static_cast<int64_t>(p.Lq) * p.Hq);
  store_f(o, b * p.o.b + h * p.o.h + qi * p.o.l + d,
          ll > 0.0f ? out / ll : 0.0f);
}

// ---------------------------------------------------------------------------
// launches

template <typename T, int D>
cudaError_t launch_decode(const T* q, const T* k, const T* v, T* o,
                          float* scratch, int64_t scratch_floats,
                          const Problem& p, cudaStream_t stream) {
  const DecodePlan pl = decode_plan(p, D);
  const int64_t rows = static_cast<int64_t>(p.B) * p.Hq * p.Lq;
  if (scratch == nullptr || rows * pl.nsplit * (D + 2) > scratch_floats)
    return cudaErrorInvalidValue;
  const int smem = DecLayout<T, D>::bytes(pl.hp * p.Lq);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  flash_decode_kernel<T, D><<<dim3(pl.nsplit, p.Hkv * pl.nrc, p.B),
                              kDecThreads, smem, stream>>>(q, k, v, scratch, p,
                                                           pl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge as a programmatic dependent launch: its launch overlaps the
  // decode kernel instead of following its end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows));
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* part = scratch;
  err = cudaLaunchKernelEx(&cfg, flash_decode_merge<T, D>, part, o, p,
                           pl.nsplit);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* scratch, int64_t scratch_floats, const Problem& p,
                   cudaStream_t stream) {
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  auto* ot = static_cast<T*>(o);
  if (p.Lq <= kRowsMaxLq)
    return launch_decode<T, D>(qt, kt, vt, ot, scratch, scratch_floats, p,
                               stream);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = WgLayout<D>::SMEM;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const int nqb = (p.Lq + kWgBQ - 1) / kWgBQ;
    flash_wgmma_kernel<D><<<dim3(nqb, p.Hq, p.B), kWgThreads, smem, stream>>>(
        qt, kt, vt, ot, p);
    return cudaGetLastError();
  } else {
    constexpr int smem = tile_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tile_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const int nqb = (p.Lq + kBQ - 1) / kBQ;
    flash_tile_kernel<T, D><<<dim3(nqb, p.Hq, p.B), kTileThreads, smem,
                              stream>>>(qt, kt, vt, ot, p);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k,
                       const void* v, void* o, float* scratch,
                       int64_t scratch_floats, const Problem& p,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, scratch, scratch_floats, p, stream);
    case 64: return launch<T, 64>(q, k, v, o, scratch, scratch_floats, p, stream);
    case 80: return launch<T, 80>(q, k, v, o, scratch, scratch_floats, p, stream);
    case 96: return launch<T, 96>(q, k, v, o, scratch, scratch_floats, p, stream);
    case 112: return launch<T, 112>(q, k, v, o, scratch, scratch_floats, p, stream);
    case 128: return launch<T, 128>(q, k, v, o, scratch, scratch_floats, p, stream);
    case 192: return launch<T, 192>(q, k, v, o, scratch, scratch_floats, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// 16-byte alignment of a tensor's base and of its batch, head and sequence
// strides (elements of `esize` bytes).
bool aligned16(const void* ptr, const int64_t* strides, int esize) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if ((strides[i] * esize) % 16) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); head_dim in
// {32, 64, 80, 96, 112, 128, 192}.  `strides` (host memory) holds the batch, head and sequence
// element strides of q, k, v and o, in that order (12 values).  Decode
// (Lq <= 16) writes per-split partials to `scratch`, a float32 device buffer
// of `scratch_floats` >= B·Hq·Lq·32·(head_dim + 2), which a second launch
// merges; prefill does not touch it.  Returns cudaGetLastError() after the
// launches.
extern "C" int repro_flash_attention(int dtype, int head_dim, const void* q,
                                     const void* k, const void* v, void* o,
                                     int B, int Hq, int Hkv, int Lq, int Lk,
                                     const int64_t* strides, int causal,
                                     int window, float sm_scale, void* scratch,
                                     int64_t scratch_floats, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Lq < 1 || Lk < 1 || Hq % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
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
  const int esize = dtype == 0 ? 4 : 2;
  p.vec = aligned16(q, strides, esize) && aligned16(k, strides + 3, esize) &&
          aligned16(v, strides + 6, esize);
  auto s = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<float*>(scratch);
  const cudaError_t err =
      dtype == 0
          ? launch_dim<float>(head_dim, q, k, v, o, sc, scratch_floats, p, s)
          : launch_dim<bf16>(head_dim, q, k, v, o, sc, scratch_floats, p, s);
  return static_cast<int>(err);
}
