// A K-event weighted apply with no statistics on every leaf of a tree, in
// one launch.
//
// Replaces the TPU kernel
// `repro/kernels/batched_update.py::batched_scale_apply_2d` (Pallas body
// `_kernel`), one `pallas_call` per leaf.  Per element:
//
//   w_k = m_k · c_k                   (c_k alone when there is no mask)
//   Δ   = Σ_k w_k · g_k                         ('coeff' mode)
//       | Σ_k w_k · lr / (v τ_k + ε) · g_k      ('fasgd' mode)
//   θ'  = θ - Δ
//
// The sum runs k = 0..K-1 in order from an fp32 zero, each term grouped as
// (w_k · scale_k) · g_k, as the TPU kernel's fori_loop does; θ and g are
// fp32 or bf16 (template; one dtype per launch), g is cast to fp32 before
// the product and θ' is rounded once.  Built with -fmad=false and IEEE
// division (no fast math): every multiply, add and division rounds on its
// own, as the plain version's separate elementwise ops do, so the two agree
// to the last bit.  `coeffs`, `taus` and `masks` are [K] per leaf (per-leaf
// gating gives each leaf its own), so the table carries them beside the
// leaf's θ, g, v and θ'.
//
// Bound: bytes.  Each element reads θ, v ('fasgd' only) and its K
// gradients once and writes θ' once: (K + 3)·4 B per element with θ in
// fp32, 83.32 MB for the 784-200-10 MLP at K = 128 (24.87 us at
// 3.35 TB/s), against some 6 operations per element and event (about
// 1.8 us at 67 TFLOP/s).  What kept the first kernel (one thread per 1-4
// elements, walking all K events) from that bound was latency, not bytes:
// on the MLP's small leaves a handful of threads each ran K IEEE divisions
// in series (each a guarded slow-path call in its own convergence region,
// which the scheduler cannot interleave), and the leaves ran as four
// launches one after the other.  The design:
//
// * one launch per tree: the leaves go in a LeafTable (common.cuh), and a
//   block owns a tile of consecutive elements of one leaf and all K
//   events, so the small leaves' blocks run beside the big ones'.  Each
//   leaf takes one of two paths, chosen by the host (`ops._batched_tiles`)
//   and marked in `terms_leaves`:
// * the rows path, for the big leaves and for any leaf at K <= 16: a tile
//   of 256·V elements, V consecutive ones a thread (V = 4 up to 16
//   events, 2 above), summed in registers over the K events in order, the
//   gradient rows loaded 32 / V at a time with one 4V-byte (fp32) or
//   2V-byte (bf16) load each where the leaf's length and pointers allow,
//   else with masked scalar loads, the weights and τ of each row read
//   through the read-only cache beside them (no barrier).  A thread's V·K
//   divisions run in series, which is short at K <= 16 and hidden, on a
//   big leaf, by the other warps of its SM;
// * the terms path, for a leaf too small to give the rows path a block
//   per SM when K > 16 (the MLP's b0, b1 and w1): a tile of `tile` (32 to
//   256, a power of two) elements, the events in chunks of `chunk` =
//   min(K, kTerms / tile).  The 256 threads compute the chunk's
//   chunk·tile terms (w_k · scale_k) · g_k in parallel, each at most
//   kTerms / 256 = 16 of them with all its gradient loads in flight at
//   once (issued before the chunk's weights and τ are staged in shared
//   memory, so the two round trips overlap) and its divisions independent,
//   and write them to shared memory as [chunk][tile].  Every term a
//   thread computes lies in one column (the tile divides 256), so it holds
//   that element's v in a register, and a warp takes 32 consecutive
//   elements of one event row, so the gradient loads are coalesced.  Then
//   one thread per element adds its column in order, k = 0..K-1, from an
//   fp32 zero, carrying the sum across chunks in a register, and writes θ'
//   once.  The serial part is K dependent adds from shared memory.  A warp
//   reads one row of 32 consecutive columns at a time, so neither the
//   writes nor the column sums conflict on banks and the rows need no pad;
// * 'coeff' mode stages no τ and never loads v.
//
// On an H100 SXM (chip_smoke.py phase 11, L2 flushed) the K = 128 MLP
// window takes about 49 us ('fasgd') and 43 us ('coeff'), nearly all of it
// w0 on the rows path, which streams at about 2 TB/s where a 2M-element
// leaf at the same K streams at about 3 TB/s: w0 gives the rows path only
// 2 or 3 blocks per SM.  Alone, the small leaves take about 9 us on the
// terms path against 29-31 us in the first kernel; on the rows path they
// took 20-40 us.  4 elements a thread on the rows path, or w0 on the terms
// path, measured slower at K = 128.
//
// lr and ε go by value.  K is at most kMaxEvents, the wrapper's limit
// since the first kernel (shared memory does not depend on K).

#include <climits>

#include "common.cuh"

namespace {

using repro::kThreads;
using repro::load_f;
using repro::store_f;

constexpr int kMaxEvents = 4096;
constexpr int kTerms = 4096;          // terms a block stages per chunk: 16 KB
constexpr int kTermsPerThread = kTerms / kThreads;
constexpr int kMinTile = 32, kMaxTile = kThreads;    // the terms path's
// The rows path: up to kWideMaxEvents events 4 elements a thread (the
// widest loads, for the big leaves that the path then takes alone), above
// it 2 (twice the blocks on a big leaf, spread more evenly over the SMs);
// 32 gradient values a thread in flight either way.
constexpr int kWideMaxEvents = 16;
constexpr int kRowsValues = 32;
template <int V>
constexpr int kRowsTile = kThreads * V;
constexpr int rows_vec(int num_events) {
  return num_events <= kWideMaxEvents ? 4 : 2;
}
// per leaf: θ g v coeffs τ masks θ'
using Table = repro::LeafTable<7>;
static_assert(sizeof(Table) + 2 * sizeof(float) + 4 * sizeof(int) <= 4096,
              "kernel parameters above the 4 KB limit");
static_assert(repro::kMaxLeaves <= 32, "terms_leaves is a 32-bit mask");

struct Leaf {
  int64_t size;
  const void *p, *g;
  const float *v, *coeffs, *taus, *masks;
  void* po;
};

__device__ __forceinline__ Leaf leaf_of(const Table& t, int l) {
  void* const* ptr = t.ptr[l];
  return Leaf{t.size[l],
              ptr[0],
              ptr[1],
              static_cast<const float*>(ptr[2]),
              static_cast<const float*>(ptr[3]),
              static_cast<const float*>(ptr[4]),
              static_cast<const float*>(ptr[5]),
              ptr[6]};
}

// (w_k · scale_k) · g_k, scale_k = lr / (v τ_k + ε) in 'fasgd' mode.
template <bool kFasgd>
__device__ __forceinline__ float term(float w, float tau, float v, float g,
                                      float lr, float eps) {
  if (kFasgd) {
    const float scale = lr / (v * tau + eps);   // eq. 7, per event
    return w * scale * g;
  }
  return w * g;
}

// w_k = m_k · c_k, or c_k without a mask.
template <bool kMask>
__device__ __forceinline__ float weight(const Leaf& f, int k) {
  return kMask ? __ldg(f.masks + k) * __ldg(f.coeffs + k)
               : __ldg(f.coeffs + k);
}

// The terms path over block `b` of leaf f (see the note above).
template <typename T, bool kFasgd, bool kMask>
__device__ __forceinline__ void terms_block(const Leaf& f, int64_t b,
                                            float lr, float eps,
                                            int num_events, int tile,
                                            int chunk, float* smem) {
  float* terms = smem;                 // [chunk][tile]
  float* w_s = terms + chunk * tile;   // [chunk]
  float* tau_s = w_s + chunk;          // [chunk] ('fasgd')
  const int shift = __ffs(tile) - 1;
  const int64_t base = b * tile;
  const int64_t left = f.size - base;
  const int here = left < tile ? static_cast<int>(left) : tile;
  const T* g = static_cast<const T*>(f.g) + base;
  const int tid = threadIdx.x;
  const int col = tid & (tile - 1);   // the column of all this thread's terms
  const bool in_leaf = col < here;
  const float v = kFasgd && in_leaf ? f.v[base + col] : 0.0f;
  const bool sums = tid < here;       // the thread that sums column tid
  const float p = sums ? load_f(static_cast<const T*>(f.p), base + tid) : 0.0f;
  float acc = 0.0f;
  for (int k0 = 0; k0 < num_events; k0 += chunk) {
    const int kc = min(chunk, num_events - k0);
    const int nterm = kc << shift;
    // term u of this thread is event k0 + tid / tile + u · (256 / tile)
    const T* grow = g + static_cast<int64_t>(k0 + (tid >> shift)) * f.size +
                    col;
    const int64_t ustride = static_cast<int64_t>(kThreads >> shift) * f.size;
    float gk[kTermsPerThread];
#pragma unroll
    for (int u = 0; u < kTermsPerThread; ++u) {
      const int j = tid + u * kThreads;
      gk[u] = j < nterm && in_leaf ? load_f(grow, u * ustride) : 0.0f;
    }
    __syncthreads();             // the last chunk's sums have read terms
    for (int k = tid; k < kc; k += kThreads) {
      w_s[k] = weight<kMask>(f, k0 + k);
      if (kFasgd) tau_s[k] = __ldg(f.taus + k0 + k);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kTermsPerThread; ++u) {
      const int j = tid + u * kThreads;
      if (j < nterm) {
        const int k = j >> shift;
        terms[j] = term<kFasgd>(w_s[k], kFasgd ? tau_s[k] : 0.0f, v, gk[u],
                                lr, eps);
      }
    }
    __syncthreads();
    if (sums) {
      for (int k = 0; k < kc; ++k) acc = acc + terms[(k << shift) + tid];
    }
  }
  if (sums) store_f(static_cast<T*>(f.po), base + tid, p - acc);
}

// The rows path over block `b` of leaf f, kVec elements a thread (see the
// note above).
template <typename T, int kVec, bool kFasgd, bool kMask>
__device__ __forceinline__ void rows_block(const Leaf& f, int64_t b,
                                           float lr, float eps,
                                           int num_events) {
  constexpr int kRows = kRowsValues / kVec;     // rows loaded at once
  const int64_t size = f.size;
  const int64_t i = b * kRowsTile<kVec> +
                    static_cast<int64_t>(threadIdx.x) * kVec;
  if (i >= size) return;
  const T* p = static_cast<const T*>(f.p);
  const T* g = static_cast<const T*>(f.g);
  T* po = static_cast<T*>(f.po);
  // every gradient row must start aligned too: size % kVec == 0
  const bool vec = i + kVec <= size && size % kVec == 0 &&
                   repro::aligned(p, kVec * sizeof(T)) &&
                   repro::aligned(g, kVec * sizeof(T)) &&
                   repro::aligned(po, kVec * sizeof(T)) &&
                   (!kFasgd || repro::aligned(f.v, kVec * sizeof(float)));
  float vv[kVec] = {};
  if (kFasgd) repro::loadn(f.v, i, size, vec, vv);
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
        const float w = weight<kMask>(f, k0 + u);
        const float tau = kFasgd ? __ldg(f.taus + k0 + u) : 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          acc[e] = acc[e] + term<kFasgd>(w, tau, vv[e], gk[u][e], lr, eps);
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
// a block, so the terms path's barriers are safe.
// At most 80 registers a thread, so that 3 blocks fit an SM.
template <typename T, int kVec, bool kFasgd, bool kMask>
__global__ void __launch_bounds__(kThreads, 3)
batched_scale_apply_kernel(const __grid_constant__ Table t, float lr,
                           float eps, int num_events, int tile, int chunk,
                           unsigned terms_leaves) {
  extern __shared__ float smem[];
  const int l = repro::find_leaf(t, blockIdx.x);
  const Leaf f = leaf_of(t, l);
  const int64_t b = blockIdx.x - t.first_block[l];
  if (terms_leaves >> l & 1u) {
    terms_block<T, kFasgd, kMask>(f, b, lr, eps, num_events, tile, chunk,
                                  smem);
  } else {
    rows_block<T, kVec, kFasgd, kMask>(f, b, lr, eps, num_events);
  }
}

struct Launch {
  Table t;
  float lr, eps;
  int num_events, tile, chunk;
  unsigned terms_leaves, blocks;
};

template <typename T, int kVec, bool kFasgd, bool kMask>
void launch_one(const Launch& a, cudaStream_t stream) {
  const size_t smem = a.terms_leaves
      ? sizeof(float) * (static_cast<size_t>(a.chunk) * a.tile + 2 * a.chunk)
      : 0;
  batched_scale_apply_kernel<T, kVec, kFasgd, kMask>
      <<<a.blocks, kThreads, smem, stream>>>(a.t, a.lr, a.eps, a.num_events,
                                             a.tile, a.chunk, a.terms_leaves);
}

template <typename T, bool kFasgd, bool kMask>
void launch_vec(const Launch& a, cudaStream_t stream) {
  rows_vec(a.num_events) == 4 ? launch_one<T, 4, kFasgd, kMask>(a, stream)
                              : launch_one<T, 2, kFasgd, kMask>(a, stream);
}

template <typename T>
void launch(const Launch& a, int fasgd, int has_mask, cudaStream_t s) {
  if (fasgd) {
    has_mask ? launch_vec<T, true, true>(a, s)
             : launch_vec<T, true, false>(a, s);
  } else {
    has_mask ? launch_vec<T, false, true>(a, s)
             : launch_vec<T, false, false>(a, s);
  }
}

}  // namespace

// sizeof the leaf table, for the loader to check its ctypes.Structure.
extern "C" int repro_batched_scale_apply_table_bytes() {
  return static_cast<int>(sizeof(Table));
}

// dtype: 0 = float32, 1 = bfloat16 (θ and g of every leaf in the table).
// mode_fasgd: 1 = 'fasgd', 0 = 'coeff' (v is then never read).  has_mask:
// 0 means the masks are unused and w_k = c_k.  Each leaf's g is
// [num_events, size], contiguous.  Bit l of `terms_leaves` puts leaf l on
// the terms path in `tile`-element tiles (a power of two in [kMinTile,
// kMaxTile]; ignored when no bit is set); the other leaves take the rows
// path in tiles of 256 · rows_vec(num_events) elements.  The table's block starts must be
// those tiles'.  Returns cudaErrorInvalidValue for an unknown dtype,
// num_events outside [1, kMaxEvents] or a bad tile or table, else
// cudaGetLastError().
extern "C" int repro_batched_scale_apply(int dtype, int mode_fasgd,
                                         int has_mask, Table table, float lr,
                                         float eps, int num_events, int tile,
                                         unsigned terms_leaves, void* stream) {
  const int nl = table.num_leaves;
  bool ok = (dtype == 0 || dtype == 1) && num_events >= 1 &&
            num_events <= kMaxEvents && nl >= 1 &&
            nl <= repro::kMaxLeaves && table.first_block[0] == 0 &&
            (terms_leaves >> (nl - 1)) <= 1u &&
            (!terms_leaves || (tile >= kMinTile && tile <= kMaxTile &&
                               (tile & (tile - 1)) == 0));
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
  const int chunk = terms_leaves
      ? (num_events < kTerms / tile ? num_events : kTerms / tile) : 0;
  Launch a{table, lr, eps, num_events, tile, chunk, terms_leaves,
           static_cast<unsigned>(blocks)};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, mode_fasgd, has_mask, s);
  } else {
    launch<__nv_bfloat16>(a, mode_fasgd, has_mask, s);
  }
  return static_cast<int>(cudaGetLastError());
}
