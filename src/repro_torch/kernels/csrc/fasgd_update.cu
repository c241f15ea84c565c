// One FASGD server push (paper eqs. 4-8) on every leaf of a tree, in one
// launch.
//
// Replaces the TPU kernel `repro/kernels/fasgd_update.py::fasgd_update_2d`
// (Pallas body `_kernel`), which works on (R, 128) tiles padded to the
// TPU's (8, 128) vregs, one `pallas_call` per leaf.  Here each leaf is
// taken flat and contiguous, of any length, and the ragged tail is masked,
// so the wrapper makes no pad or unpad copies.
//
//   n' = γ n + (1-γ) g²                                   (eq. 4)
//   b' = γ b + (1-γ) g                                    (eq. 5)
//   s  = sqrt(max(n' - b'², 0) + ε)
//   v' = β v + (1-β) s     ('intent')  |  β v + (1-β)/s  ('literal')   (eq. 6)
//   θ' = θ - lr / (v' τ + ε) · g                          (eqs. 7-8)
//
// Bound: bytes.  Each element reads θ, g, n, b, v and writes θ', n', b', v':
// 36 B per element with θ in fp32 (5.72 MB for the 784-200-10 MLP, about
// 1.7 us at 3.35 TB/s), against some 20 flops.  At that size one push is
// far below the cost of a launch and a cold round trip to memory, so the
// design spends as few of each as it can:
//
// * the whole tree is one launch: the leaves go in a LeafTable (common.cuh)
//   and each block owns one tile of kTile elements of one leaf, so the
//   leaves' round trips overlap instead of following one another;
// * each thread owns 4 consecutive elements and loads each operand with one
//   16-byte (fp32) or 8-byte (bf16 θ, g) load where the four lie in the leaf
//   and the pointers are aligned, else with masked scalar loads (the tails
//   of the 10- and 200-element leaves take the vector path or a short
//   masked one);
// * every intermediate stays in registers and each byte is touched once.
//
// On an H100 SXM (chip_smoke.py phase 5, L2 flushed) the MLP's event takes
// about 9 us, where the same launch with an empty kernel body takes about
// 5.3 us: the rest is one cold round trip for the table, τ and the data.
// 64- or 128-thread blocks and 2 elements a thread measured the same.
//
// τ arrives as a device pointer (it is computed on the device from the
// timestamps), so the host never waits for it; lr and the constants go by
// value.  θ and g are fp32 or bf16 (template; one dtype per launch); the
// statistics are fp32.
//
// Built with -fmad=false (kernels/build.py): the operations round one by
// one in the plain version's order, so the kernel agrees with it to the
// last bit or two even where the literal variant's v is ill-conditioned.

#include <climits>

#include "common.cuh"

namespace {

using repro::Consts;
using repro::kThreads;

constexpr int kVec = 4;                    // elements a thread
constexpr int kTile = kThreads * kVec;     // elements a block
// per leaf: θ g n b v θ' n' b' v'
using Table = repro::LeafTable<9>;
static_assert(sizeof(Table) + sizeof(void*) + sizeof(Consts) <= 4096,
              "kernel parameters above the 4 KB limit");

// eqs. 4-8 for one element, in the plain version's order.
template <bool kLiteral>
__device__ __forceinline__ void push(float p, float g, float n, float b,
                                     float v, float tau, const Consts& c,
                                     float& po, float& no, float& bo,
                                     float& vo) {
  no = c.gamma * n + c.one_minus_gamma * g * g;
  bo = c.gamma * b + c.one_minus_gamma * g;
  const float sd = sqrtf(fmaxf(no - bo * bo, 0.0f) + c.eps);
  vo = kLiteral ? c.beta * v + c.one_minus_beta / sd
                : c.beta * v + c.one_minus_beta * sd;
  const float scale = c.lr / (vo * tau + c.eps);
  po = p - scale * g;
}

template <typename T, bool kLiteral>
__global__ void __launch_bounds__(kThreads)
fasgd_update_kernel(const __grid_constant__ Table t,
                    const float* __restrict__ tau_ptr, Consts c) {
  const int l = repro::find_leaf(t, blockIdx.x);
  const int64_t size = t.size[l];
  const int64_t i = (blockIdx.x - t.first_block[l]) * kTile +
                    static_cast<int64_t>(threadIdx.x) * kVec;
  if (i >= size) return;
  void* const* ptr = t.ptr[l];
  const T* p = static_cast<const T*>(ptr[0]);
  const T* g = static_cast<const T*>(ptr[1]);
  const float* n = static_cast<const float*>(ptr[2]);
  const float* b = static_cast<const float*>(ptr[3]);
  const float* v = static_cast<const float*>(ptr[4]);
  T* po = static_cast<T*>(ptr[5]);
  float* no = static_cast<float*>(ptr[6]);
  float* bo = static_cast<float*>(ptr[7]);
  float* vo = static_cast<float*>(ptr[8]);
  uintptr_t wide = 0;                       // the fp32 operands
  for (int j = 2; j < 9; ++j) {
    if (j != 5) wide |= reinterpret_cast<uintptr_t>(ptr[j]);
  }
  const bool vec = i + kVec <= size && wide % (kVec * sizeof(float)) == 0 &&
                   repro::aligned(p, kVec * sizeof(T)) &&
                   repro::aligned(g, kVec * sizeof(T)) &&
                   repro::aligned(po, kVec * sizeof(T));
  const float tau = *tau_ptr;
  float pi[kVec], gi[kVec], ni[kVec], bi[kVec], vi[kVec];
  repro::loadn(g, i, size, vec, gi);
  repro::loadn(n, i, size, vec, ni);
  repro::loadn(b, i, size, vec, bi);
  repro::loadn(v, i, size, vec, vi);
  repro::loadn(p, i, size, vec, pi);
  float pq[kVec], nq[kVec], bq[kVec], vq[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    push<kLiteral>(pi[j], gi[j], ni[j], bi[j], vi[j], tau, c, pq[j], nq[j],
                   bq[j], vq[j]);
  }
  repro::storen(po, i, size, vec, pq);
  repro::storen(no, i, size, vec, nq);
  repro::storen(bo, i, size, vec, bq);
  repro::storen(vo, i, size, vec, vq);
}

template <typename T>
void launch(int literal, const Table& t, const float* tau, Consts c,
            unsigned blocks, cudaStream_t stream) {
  if (literal) {
    fasgd_update_kernel<T, true><<<blocks, kThreads, 0, stream>>>(t, tau, c);
  } else {
    fasgd_update_kernel<T, false><<<blocks, kThreads, 0, stream>>>(t, tau, c);
  }
}

}  // namespace

// sizeof the leaf table, for the loader to check its ctypes.Structure.
extern "C" int repro_fasgd_update_table_bytes() {
  return static_cast<int>(sizeof(Table));
}

// dtype: 0 = float32, 1 = bfloat16 (θ and g of every leaf in the table).
// The table's block starts must be those of kTile-element tiles.  Returns
// cudaErrorInvalidValue for a bad dtype or table, else cudaGetLastError().
extern "C" int repro_fasgd_update(int dtype, int literal, Table table,
                                  const void* tau, float lr, float gamma,
                                  float one_minus_gamma, float beta,
                                  float one_minus_beta, float eps,
                                  void* stream) {
  const int nl = table.num_leaves;
  bool ok = (dtype == 0 || dtype == 1) && nl >= 1 &&
            nl <= repro::kMaxLeaves && table.first_block[0] == 0;
  for (int l = 0; ok && l < nl; ++l) {
    ok = table.size[l] >= 0 &&
         table.first_block[l + 1] - table.first_block[l] ==
             (table.size[l] + kTile - 1) / kTile;
  }
  const int64_t blocks = ok ? table.first_block[nl] : 0;
  if (!ok || blocks < 1 || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Consts c{lr, gamma, one_minus_gamma, beta, one_minus_beta, eps};
  const auto* tf = static_cast<const float*>(tau);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(literal, table, tf, c, static_cast<unsigned>(blocks), s);
  } else {
    launch<__nv_bfloat16>(literal, table, tf, c,
                          static_cast<unsigned>(blocks), s);
  }
  return static_cast<int>(cudaGetLastError());
}
