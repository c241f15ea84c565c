// One K-event server apply on every leaf of a tree, in one launch.
//
// Replaces the TPU kernel
// `repro/kernels/fused_event_apply.py::fused_event_apply_2d` (Pallas body
// `_kernel`), one `pallas_call` per leaf.  Per element:
//
//   ḡ  = Σ_k wmean_k g_k                    (k = 0..K-1 in order)
//   n', b', v' by eqs. 4-6 against ḡ, held at n, b, v when has_push == 0;
//                with track_stats off they are not computed (the wrapper
//                hands n, b, v back unchanged)
//   Δ  = Σ_k w_k g_k                        ('coeff' mode)
//      | Σ_k (w_k · lr / (v' τ_k + ε)) g_k  ('fasgd' mode, post-stats v')
//   θ' = θ - Δ
//
// Both sums run k = 0..K-1 in order from an fp32 zero, as the TPU kernel's
// two fori_loops do, each Δ term grouped as (w_k · scale_k) · g_k; g is
// cast to fp32 before use and θ' is rounded once.  Built with -fmad=false
// and IEEE division, so with track_stats off the kernel computes what
// `batched_update.cu` computes to the last bit (chip_smoke.py phase 11
// requires it).  w, wmean, τ ([K]) and has_push (a scalar) are device
// pointers per leaf: one pointer in every row when they are shared, one
// per leaf for per-tensor gating.  lr and the eq. 4-6 constants go by
// value; θ and g are fp32 or bf16 (template; one dtype per launch), the
// statistics fp32.
//
// Bound: bytes.  Each element reads θ, n, b, v and its K gradients once
// and writes θ', n', b', v' once: (K + 8)·4 B per element with θ in fp32,
// 86.50 MB for the 784-200-10 MLP at K = 128 (25.82 us at 3.35 TB/s);
// with track_stats off (K + 3)·4 B ('fasgd').  The first kernel (one
// thread per element walking all K events twice, one launch per leaf)
// took 176 us for that window: on the small leaves a few threads each ran
// two K-long chains, one of them K IEEE divisions, in series, and the four
// leaves ran one launch after another.  The design, after the one
// batched_update.cu measured:
//
// * one launch per tree: the leaves go in a LeafTable (common.cuh), a
//   block owns a tile of consecutive elements of one leaf and all K
//   events, and each leaf takes one of two paths, chosen by the host
//   (`ops._fused_plan`) and marked in `terms_leaves`;
// * the rows path, for the big leaves and for any leaf at K <= 16 or
//   K > 256: a tile of 256·V elements, V consecutive ones a thread (4 up
//   to 16 events, 2 above), the ḡ sum in registers, the statistics, then
//   the Δ sum, each pass loading the gradient rows 32 / V at a time (one
//   4V- or 2V-byte load each where the leaf's length and pointers allow,
//   else masked scalar loads).  The gradients are read twice; the second
//   pass finds them in L2 where the launch's gradients fit there;
// * the terms path, for a leaf too small to give the rows path a block
//   per SM when 16 < K <= 256 (the MLP's b0, b1 and w1 at K = 128): a tile
//   of `tile` elements (32 to 256, a power of two, K·tile <= 8192) whose
//   K gradient rows the 256 threads stage in shared memory once, as fp32,
//   16 coalesced loads a thread in flight.  One thread per element sums
//   ḡ down its column in k order, computes n', b', v' and puts v' in
//   shared memory; after a barrier the 256 threads compute the K·tile Δ
//   terms in parallel, in place, each thread's terms in one column (the
//   tile divides 256) so it holds that v' in a register; after another
//   barrier each element's thread adds its column in k order and writes θ'
//   once.  g is read once from device memory and no thread runs a chain of
//   divisions.  'coeff' mode has no division and sums w_k·g_k down the
//   column directly, with no third phase.  A warp reads 32 consecutive
//   columns of one row at a time, so no access conflicts on banks.
//
// On an H100 SXM (chip_smoke.py phase 5, L2 flushed) the K = 128 MLP
// window takes about 78 us with track_stats on and 48 us without (the
// same as batched_update.cu), nearly all of it w0 on the rows path: its
// 80 MB of gradients are above the 50 MB L2, so most of the second read
// comes from device memory.  Two other designs for w0 measured slower:
// the terms path (g staged once, 85-90 us; each block's 128 rows of 128 B
// lie in as many DRAM pages), and rows blocks capped at one per SM, each
// walking a run of 256-element tiles so that the second read finds L2
// (176 us; 1-element rows spill).  Reading the terms path's column sums
// 16 values ahead of their adds changed nothing.
//
// K is at most kMaxEvents.

#include <climits>

#include "common.cuh"

namespace {

using repro::Consts;
using repro::kThreads;
using repro::load_f;
using repro::store_f;

constexpr int kMaxEvents = 4096;
constexpr int kMinTile = 32, kMaxTile = kThreads;     // the terms path's
constexpr int kStageFloats = 8192;    // its staged gradient tile: 32 KB
constexpr int kStageBatch = 16;       // gradient loads a thread has in flight
// The rows path: up to kWideMaxEvents events 4 elements a thread, above it
// 2; 32 gradient values a thread in flight either way.
constexpr int kWideMaxEvents = 16;
constexpr int kRowsValues = 32;
template <int V>
constexpr int kRowsTile = kThreads * V;
constexpr int rows_vec(int num_events) {
  return num_events <= kWideMaxEvents ? 4 : 2;
}
// per leaf: θ g n b v w wmean τ has_push θ' n' b' v'
using Table = repro::LeafTable<13>;
static_assert(sizeof(Table) == 3856, "build.FUSED_TABLE mirrors this layout");
static_assert(sizeof(Table) + sizeof(Consts) + 3 * sizeof(int) <= 4096,
              "kernel parameters above the 4 KB limit");
static_assert(repro::kMaxLeaves <= 32, "terms_leaves is a 32-bit mask");

struct Leaf {
  int64_t size;
  const void *p, *g;
  const float *n, *b, *v, *w, *wmean, *tau, *has_push;
  void* po;
  float *no, *bo, *vo;
};

__device__ __forceinline__ Leaf leaf_of(const Table& t, int l) {
  void* const* q = t.ptr[l];
  auto in = [&](int j) { return static_cast<const float*>(q[j]); };
  auto out = [&](int j) { return static_cast<float*>(q[j]); };
  return Leaf{t.size[l], q[0],   q[1],   in(2),  in(3),  in(4),  in(5),
              in(6),     in(7),  in(8),  q[9],   out(10), out(11), out(12)};
}

// (w_k · scale_k) · g_k, scale_k = lr / (v τ_k + ε) in 'fasgd' mode: the
// term of batched_update.cu, rounded the same way.
template <bool kFasgd>
__device__ __forceinline__ float term(float w, float tau, float v, float g,
                                      float lr, float eps) {
  if (kFasgd) {
    const float scale = lr / (v * tau + eps);   // eq. 7, per event
    return w * scale * g;
  }
  return w * g;
}

// Eqs. 4-6 against ḡ, in the plain version's order; the results replace
// n, b, v when `push`.
template <bool kLiteral>
__device__ __forceinline__ void stats(float gbar, bool push, const Consts& c,
                                      float& n, float& b, float& v) {
  const float nn = c.gamma * n + c.one_minus_gamma * gbar * gbar;   // eq. 4
  const float bb = c.gamma * b + c.one_minus_gamma * gbar;          // eq. 5
  const float sd = sqrtf(fmaxf(nn - bb * bb, 0.0f) + c.eps);
  const float vv = kLiteral ? c.beta * v + c.one_minus_beta / sd
                            : c.beta * v + c.one_minus_beta * sd;   // eq. 6
  if (push) {
    n = nn;
    b = bb;
    v = vv;
  }
}

// The terms path over block `blk` of leaf f (see the note above).
template <typename T, bool kFasgd, bool kTrack, bool kLiteral>
__device__ __forceinline__ void terms_block(const Leaf& f, int64_t blk,
                                            const Consts& c, int num_events,
                                            int tile, float* smem) {
  const int shift = __ffs(tile) - 1;
  float* gs = smem;                               // [K][tile]
  float* w_s = gs + (num_events << shift);        // [K]
  float* wm_s = w_s + num_events;                 // [K] (track_stats)
  float* tau_s = wm_s + num_events;               // [K] ('fasgd')
  float* v_s = tau_s + num_events;                // [tile] ('fasgd')
  const int64_t base = blk * tile;
  const int64_t left = f.size - base;
  const int here = left < tile ? static_cast<int>(left) : tile;
  const int tid = threadIdx.x;
  const int col = tid & (tile - 1);    // the column of this thread's terms
  const bool in_leaf = col < here;
  const bool owns = tid < here;        // the thread of element base + tid
  // the element's own operands, loaded while the gradients are staged
  float p = 0.0f, n = 0.0f, b = 0.0f, v = 0.0f;
  bool push = false;
  if (owns) {
    p = load_f(static_cast<const T*>(f.p), base + tid);
    if (kFasgd || kTrack) v = f.v[base + tid];
    if (kTrack) {
      n = f.n[base + tid];
      b = f.b[base + tid];
      push = *f.has_push > 0.0f;
    }
  }
  // stage g[k][base + col], k = 0..K-1: entry j of the tile is event
  // j / tile, column j % tile; a thread's entries all lie in its column
  const T* g = static_cast<const T*>(f.g) + base + col;
  const int nstage = num_events << shift;
  for (int j0 = tid; j0 < nstage; j0 += kThreads * kStageBatch) {
    float x[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int j = j0 + u * kThreads;
      x[u] = j < nstage && in_leaf
                 ? load_f(g, static_cast<int64_t>(j >> shift) * f.size)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int j = j0 + u * kThreads;
      if (j < nstage) gs[j] = x[u];
    }
  }
  for (int k = tid; k < num_events; k += kThreads) {
    w_s[k] = __ldg(f.w + k);
    if (kTrack) wm_s[k] = __ldg(f.wmean + k);
    if (kFasgd) tau_s[k] = __ldg(f.tau + k);
  }
  __syncthreads();
  if (kTrack && owns) {
    float gbar = 0.0f;
    for (int k = 0; k < num_events; ++k) {
      gbar = gbar + wm_s[k] * gs[(k << shift) + tid];
    }
    stats<kLiteral>(gbar, push, c, n, b, v);
    f.no[base + tid] = n;
    f.bo[base + tid] = b;
    f.vo[base + tid] = v;
  }
  float acc = 0.0f;
  if (kFasgd) {
    if (tid < tile) v_s[tid] = owns ? v : 1.0f;
    __syncthreads();
    const float vc = v_s[col];
    for (int j = tid; j < nstage; j += kThreads) {
      const int k = j >> shift;
      gs[j] = term<true>(w_s[k], tau_s[k], vc, gs[j], c.lr, c.eps);
    }
    __syncthreads();
    if (owns) {
      for (int k = 0; k < num_events; ++k) acc = acc + gs[(k << shift) + tid];
    }
  } else if (owns) {
    for (int k = 0; k < num_events; ++k) {
      acc = acc + term<false>(w_s[k], 0.0f, 0.0f, gs[(k << shift) + tid],
                              c.lr, c.eps);
    }
  }
  if (owns) store_f(static_cast<T*>(f.po), base + tid, p - acc);
}

// The rows path over block `blk` of leaf f, kVec elements a thread (see
// the note above).
template <typename T, int kVec, bool kFasgd, bool kTrack, bool kLiteral>
__device__ __forceinline__ void rows_block(const Leaf& f, int64_t blk,
                                           const Consts& c, int num_events) {
  constexpr int kRows = kRowsValues / kVec;     // rows loaded at once
  constexpr size_t kT = kVec * sizeof(T), kF = kVec * sizeof(float);
  const int64_t size = f.size;
  const int64_t i = blk * kRowsTile<kVec> +
                    static_cast<int64_t>(threadIdx.x) * kVec;
  if (i >= size) return;
  const T* p = static_cast<const T*>(f.p);
  const T* g = static_cast<const T*>(f.g);
  T* po = static_cast<T*>(f.po);
  // every gradient row must start aligned too: size % kVec == 0
  bool vec = i + kVec <= size && size % kVec == 0 &&
             repro::aligned(p, kT) && repro::aligned(g, kT) &&
             repro::aligned(po, kT);
  if (kFasgd || kTrack) vec = vec && repro::aligned(f.v, kF);
  if (kTrack) {
    vec = vec && repro::aligned(f.n, kF) && repro::aligned(f.b, kF) &&
          repro::aligned(f.no, kF) && repro::aligned(f.bo, kF) &&
          repro::aligned(f.vo, kF);
  }
  float v[kVec] = {};
  if (kFasgd || kTrack) repro::loadn(f.v, i, size, vec, v);
  if (kTrack) {
    float gbar[kVec] = {};
    for (int k0 = 0; k0 < num_events; k0 += kRows) {
      float gk[kRows][kVec];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (k0 + u < num_events) {
          repro::loadn(g + static_cast<int64_t>(k0 + u) * size, i, size, vec,
                       gk[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (k0 + u < num_events) {
          const float wm = __ldg(f.wmean + k0 + u);
#pragma unroll
          for (int e = 0; e < kVec; ++e) gbar[e] = gbar[e] + wm * gk[u][e];
        }
      }
    }
    float n[kVec], b[kVec];
    repro::loadn(f.n, i, size, vec, n);
    repro::loadn(f.b, i, size, vec, b);
    const bool push = *f.has_push > 0.0f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      stats<kLiteral>(gbar[e], push, c, n[e], b[e], v[e]);
    }
    repro::storen(f.no, i, size, vec, n);
    repro::storen(f.bo, i, size, vec, b);
    repro::storen(f.vo, i, size, vec, v);
  }
  float acc[kVec] = {};
  for (int k0 = 0; k0 < num_events; k0 += kRows) {
    float gk[kRows][kVec];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (k0 + u < num_events) {
        repro::loadn(g + static_cast<int64_t>(k0 + u) * size, i, size, vec,
                     gk[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (k0 + u < num_events) {
        const float w = __ldg(f.w + k0 + u);
        const float tau = kFasgd ? __ldg(f.tau + k0 + u) : 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          acc[e] = acc[e] + term<kFasgd>(w, tau, v[e], gk[u][e], c.lr, c.eps);
        }
      }
    }
  }
  float out[kVec];
  repro::loadn(p, i, size, vec, out);
#pragma unroll
  for (int e = 0; e < kVec; ++e) out[e] = out[e] - acc[e];
  repro::storen(po, i, size, vec, out);
}

// Bit l of `terms_leaves` sends leaf l down the terms path (in `tile`-
// element tiles), the rest take the rows path; the choice is uniform over
// a block, so the terms path's barriers are safe.  At most 80 registers a
// thread, so that 3 blocks fit an SM.
template <typename T, int kVec, bool kFasgd, bool kTrack, bool kLiteral>
__global__ void __launch_bounds__(kThreads, 3)
fused_event_apply_kernel(const __grid_constant__ Table t, Consts c,
                         int num_events, int tile, unsigned terms_leaves) {
  extern __shared__ float smem[];
  const int l = repro::find_leaf(t, blockIdx.x);
  const Leaf f = leaf_of(t, l);
  const int64_t blk = blockIdx.x - t.first_block[l];
  if (terms_leaves >> l & 1u) {
    terms_block<T, kFasgd, kTrack, kLiteral>(f, blk, c, num_events, tile,
                                             smem);
  } else {
    rows_block<T, kVec, kFasgd, kTrack, kLiteral>(f, blk, c, num_events);
  }
}

struct Launch {
  Table t;
  Consts c;
  int num_events, tile;
  unsigned terms_leaves, blocks;
};

template <typename T, int kVec, bool kFasgd, bool kTrack, bool kLiteral>
void launch_one(const Launch& a, cudaStream_t stream) {
  // [K][tile] gradients, w, wmean and τ [K], v' [tile]
  const size_t smem = a.terms_leaves
      ? sizeof(float) * (static_cast<size_t>(a.num_events) * a.tile +
                         3 * a.num_events + a.tile)
      : 0;
  fused_event_apply_kernel<T, kVec, kFasgd, kTrack, kLiteral>
      <<<a.blocks, kThreads, smem, stream>>>(a.t, a.c, a.num_events, a.tile,
                                             a.terms_leaves);
}

template <typename T, bool kFasgd, bool kTrack, bool kLiteral>
void launch_vec(const Launch& a, cudaStream_t s) {
  rows_vec(a.num_events) == 4
      ? launch_one<T, 4, kFasgd, kTrack, kLiteral>(a, s)
      : launch_one<T, 2, kFasgd, kTrack, kLiteral>(a, s);
}

template <typename T, bool kFasgd>
void launch_mode(const Launch& a, int track, int literal, cudaStream_t s) {
  if (!track) {
    launch_vec<T, kFasgd, false, false>(a, s);
  } else if (literal) {
    launch_vec<T, kFasgd, true, true>(a, s);
  } else {
    launch_vec<T, kFasgd, true, false>(a, s);
  }
}

template <typename T>
void launch(const Launch& a, int fasgd, int track, int literal,
            cudaStream_t s) {
  fasgd ? launch_mode<T, true>(a, track, literal, s)
        : launch_mode<T, false>(a, track, literal, s);
}

}  // namespace

// sizeof the leaf table, for the loader to check its ctypes.Structure.
extern "C" int repro_fused_event_apply_table_bytes() {
  return static_cast<int>(sizeof(Table));
}

// dtype: 0 = float32, 1 = bfloat16 (θ and g of every leaf in the table).
// mode_fasgd: 1 = 'fasgd', 0 = 'coeff'.  track_stats: 0 leaves n, b, v,
// has_push, wmean and the n', b', v' pointers unread (v is still read in
// 'fasgd' mode).  Each leaf's g is [num_events, size], contiguous.  Bit l
// of `terms_leaves` puts leaf l on the terms path in `tile`-element tiles
// (a power of two in [kMinTile, kMaxTile] with num_events · tile <=
// kStageFloats; ignored when no bit is set); the other leaves take the
// rows path in tiles of 256 · rows_vec(num_events) elements.  The table's
// block starts must be those tiles'.  Returns cudaErrorInvalidValue for an
// unknown dtype, num_events outside [1, kMaxEvents] or a bad tile or
// table, else cudaGetLastError().
extern "C" int repro_fused_event_apply(int dtype, int mode_fasgd,
                                       int track_stats, int literal,
                                       Table table, float lr, float gamma,
                                       float one_minus_gamma, float beta,
                                       float one_minus_beta, float eps,
                                       int num_events, int tile,
                                       unsigned terms_leaves, void* stream) {
  const int nl = table.num_leaves;
  bool ok = (dtype == 0 || dtype == 1) && num_events >= 1 &&
            num_events <= kMaxEvents && nl >= 1 &&
            nl <= repro::kMaxLeaves && table.first_block[0] == 0 &&
            (terms_leaves >> (nl - 1)) <= 1u &&
            (!terms_leaves ||
             (tile >= kMinTile && tile <= kMaxTile &&
              (tile & (tile - 1)) == 0 &&
              static_cast<int64_t>(num_events) * tile <= kStageFloats));
  const int rows_tile = kThreads * rows_vec(num_events);
  for (int l = 0; ok && l < nl; ++l) {
    const int64_t leaf_tile = terms_leaves >> l & 1u ? tile : rows_tile;
    ok = table.size[l] >= 0 &&
         table.first_block[l + 1] - table.first_block[l] ==
             (table.size[l] + leaf_tile - 1) / leaf_tile;
  }
  const int64_t blocks = ok ? table.first_block[nl] : 0;
  if (!ok || blocks < 1 || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a{table,
           Consts{lr, gamma, one_minus_gamma, beta, one_minus_beta, eps},
           num_events,
           tile,
           terms_leaves,
           static_cast<unsigned>(blocks)};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, mode_fasgd, track_stats, literal, s);
  } else {
    launch<__nv_bfloat16>(a, mode_fasgd, track_stats, literal, s);
  }
  return static_cast<int>(cudaGetLastError());
}
