// Fused oldest-k ping-target candidates, one row per block.
//
// Replaces the Pallas kernel kaboodle_tpu/ops/fused_oldest_k.py::
// fused_oldest_k (pallas_call at fused_oldest_k.py:119, body _make_kernel
// at :39-73). Per row i, over the eligible cells
//
//   alive[i] & state[i,j] == KNOWN & j != i & timer[i,j] != max(timer dtype)
//
// it returns the k lexicographically smallest (timer, j) in order: idx[i, r]
// is the r-th one's column (n - 1 in a slot with no candidate) and
// valid[i, r] whether it exists.
//
// Bound: bytes. Each cell is read once (1 byte of state, 2 or 4 of timer)
// against a compare or two. The Pallas kernel runs k full min-reduction
// rounds over a VMEM-resident row tile; here a block reads its row ONCE:
// each thread keeps its own sorted list of its k smallest keys (the packed
// 64-bit (timer, j) key of common.cuh) in registers, the 32 lists of a warp
// merge by k rounds of a warp-wide min (the owner of the minimum pops its
// head; keys are unique, so exactly one lane pops), and the warps' merged
// lists merge the same way in warp 0. A dead row reads nothing: it has no
// eligible cell.
#include "common.cuh"

namespace {

constexpr int kKnown = 1;
constexpr int kMaxK = 8;

template <int K>
__device__ __forceinline__ void insert_key(long long (&l)[K], long long key) {
  if (key < l[K - 1]) {
    l[K - 1] = key;
#pragma unroll
    for (int q = K - 1; q > 0; --q) {
      if (l[q] < l[q - 1]) {
        const long long tmp = l[q];
        l[q] = l[q - 1];
        l[q - 1] = tmp;
      }
    }
  }
}

// Merge the sorted lists of the 32 lanes of a warp into the warp's k
// smallest keys, in order (valid in every lane).
template <int K>
__device__ __forceinline__ void warp_merge(long long (&l)[K], long long (&out)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const long long m = warp_reduce(l[0], MinOp());
    const long long m_all = __shfl_sync(0xffffffffu, m, 0);
    out[r] = m_all;
    if (l[0] == m_all) {
#pragma unroll
      for (int q = 0; q < K - 1; ++q) l[q] = l[q + 1];
      l[K - 1] = LLONG_MAX;
    }
  }
}

template <typename TT, int K>
__global__ void __launch_bounds__(KB_THREADS)
fused_oldest_k_kernel(const int8_t* __restrict__ state, const TT* __restrict__ timer,
                      const uint8_t* __restrict__ alive, int32_t* __restrict__ out_idx,
                      uint8_t* __restrict__ out_valid, int n, int vec, int tmax) {
  __shared__ long long lists[KB_THREADS / 32][K];
  const int row = blockIdx.x;
  const int8_t* srow = state + static_cast<size_t>(row) * n;
  const TT* trow = timer + static_cast<size_t>(row) * n;
  long long l[K];
#pragma unroll
  for (int q = 0; q < K; ++q) l[q] = LLONG_MAX;
  if (alive[row] != 0) {
    if (vec) {
      for (int v = threadIdx.x; v < n / 16; v += blockDim.x) {
        alignas(16) int8_t s[16];
        alignas(16) TT t[16];
        load16(srow + 16 * v, s);
        load16(trow + 16 * v, t);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int j = 16 * v + k;
          const int tv = t[k];
          if (s[k] == kKnown && j != row && tv != tmax) insert_key(l, lex_key(tv, j));
        }
      }
    } else {
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int tv = trow[j];
        if (srow[j] == kKnown && j != row && tv != tmax) insert_key(l, lex_key(tv, j));
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long merged[K];
  warp_merge(l, merged);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) lists[warp][q] = merged[q];
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
    for (int q = 0; q < K; ++q) l[q] = lane < nwarps ? lists[lane][q] : LLONG_MAX;
    warp_merge(l, merged);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const bool ok = merged[q] != LLONG_MAX;
        out_idx[static_cast<size_t>(row) * K + q] =
            ok ? static_cast<int>(merged[q] & 0xFFFFFFFFLL) : n - 1;
        out_valid[static_cast<size_t>(row) * K + q] = ok;
      }
    }
  }
}

template <typename TT>
int launch(const int8_t* s, const TT* t, const uint8_t* a, int32_t* idx, uint8_t* valid,
           int n, int k, int vec, int tmax, cudaStream_t st) {
  switch (k) {
#define KB_CASE(KK)                                                                    \
  case KK:                                                                             \
    fused_oldest_k_kernel<TT, KK><<<n, KB_THREADS, 0, st>>>(s, t, a, idx, valid, n, vec, \
                                                            tmax);                     \
    break;
    KB_CASE(1) KB_CASE(2) KB_CASE(3) KB_CASE(4) KB_CASE(5) KB_CASE(6) KB_CASE(7) KB_CASE(8)
#undef KB_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// state int8 [n, n]; timer int16 (timer_bytes 2) or int32 (4) [n, n];
// alive bool [n]; outputs idx int32 [n, k], valid bool [n, k]; 1 <= k <= 8.
extern "C" int kb_fused_oldest_k(const void* state, const void* timer, int timer_bytes,
                                 const void* alive, int k, void* idx, void* valid,
                                 int n, int vec, void* stream) {
  if (n <= 0 || k < 1 || k > kMaxK || (timer_bytes != 2 && timer_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* s = static_cast<const int8_t*>(state);
  const auto* a = static_cast<const uint8_t*>(alive);
  auto* ix = static_cast<int32_t*>(idx);
  auto* va = static_cast<uint8_t*>(valid);
  auto st = static_cast<cudaStream_t>(stream);
  if (timer_bytes == 2) {
    return launch(s, static_cast<const int16_t*>(timer), a, ix, va, n, k, vec, INT16_MAX, st);
  }
  return launch(s, static_cast<const int32_t*>(timer), a, ix, va, n, k, vec, INT32_MAX, st);
}
