// Fused membership fingerprint + count, one row per block.
//
// Replaces the Pallas kernel kaboodle_tpu/ops/fused_fp.py::fused_fp_count
// (pallas_call at fused_fp.py:129 with body _kernel_idv, identity-view mode,
// and fused_fp.py:139 with body _kernel_hash, record-hash mode):
//
//   fp[i]    = sum_{j : state[i,j] > 0} h(i, j)   (mod 2^32)
//   count[i] = |{j : state[i,j] > 0}|
//
// with h(i, j) = mix32(mix32(j ^ 0x9E3779B9) ^ id_view[i,j]) in id-view
// mode and h(i, j) = rec_hash[j] in hash mode.
//
// Bound: bytes. Each cell is read once (1 byte of state, plus 4 bytes of
// id_view in id-view mode) against a handful of integer operations, far
// below the card's operations-per-byte balance. The design reads every row
// once with 16-byte loads, neighbouring threads on neighbouring words, and
// keeps the hash, the mask and both sums in registers: no [N, N]
// intermediate exists. The sum wraps in uint32, which is order-free, so
// the shuffle/shared-memory reduction tree gives the exact bits of the
// sequential sum.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t record_hash(uint32_t j, uint32_t id) {
  return mix32(mix32(j ^ 0x9E3779B9u) ^ id);
}

template <bool kIdv>
__global__ void __launch_bounds__(KB_THREADS)
fused_fp_kernel(const int8_t* __restrict__ state, const uint32_t* __restrict__ ident,
                uint32_t* __restrict__ fp, int32_t* __restrict__ cnt, int n, int vec) {
  const int row = blockIdx.x;
  const int8_t* srow = state + static_cast<size_t>(row) * n;
  const uint32_t* irow = kIdv ? ident + static_cast<size_t>(row) * n : ident;
  uint32_t acc = 0;
  int members = 0;
  if (vec) {
    for (int v = threadIdx.x; v < n / 16; v += blockDim.x) {
      alignas(16) int8_t s[16];
      alignas(16) uint32_t w[16];
      load16(srow + 16 * v, s);
      load16(irow + 16 * v, w);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t h = kIdv ? record_hash(16 * v + k, w[k]) : w[k];
        const bool m = s[k] > 0;
        acc += m ? h : 0u;
        members += m;
      }
    }
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      if (srow[j] > 0) {
        acc += kIdv ? record_hash(j, irow[j]) : irow[j];
        ++members;
      }
    }
  }
  acc = block_reduce(acc, SumOp(), 0u);
  members = block_reduce(members, SumOp(), 0);
  if (threadIdx.x == 0) {
    fp[row] = acc;
    cnt[row] = members;
  }
}

}  // namespace

// state int8 [n, n]; ident uint32 [n, n] (idv != 0) or uint32 [n] record
// hashes; outputs fp uint32 [n], cnt int32 [n]. Returns cudaGetLastError().
extern "C" int kb_fused_fp(const void* state, const void* ident, void* fp, void* cnt,
                           int n, int idv, int vec, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const int8_t*>(state);
  const auto* id = static_cast<const uint32_t*>(ident);
  auto* f = static_cast<uint32_t*>(fp);
  auto* c = static_cast<int32_t*>(cnt);
  auto st = static_cast<cudaStream_t>(stream);
  if (idv) {
    fused_fp_kernel<true><<<n, KB_THREADS, 0, st>>>(s, id, f, c, n, vec);
  } else {
    fused_fp_kernel<false><<<n, KB_THREADS, 0, st>>>(s, id, f, c, n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
