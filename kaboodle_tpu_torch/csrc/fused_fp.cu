// Fused membership fingerprint + count: a warp owns a band of rows.
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
// Bound: bytes. The function must read each cell once: 1 byte of state, and
// 4 bytes of id_view in id-view mode; the N record hashes are read once in
// all. In id-view mode the two mix32 a cell come close to the bytes' time
// (about 21 integer operations a cell against 5 bytes), so the design
// shares what it can between rows:
//
// - No block barrier, no shared memory: a warp owns a band of kBand rows
//   (one row below kLongN columns, where a short row needs the warps more
//   than the shared work), a block holds kWarps warps. Rows stream in
//   512-cell chunks, 16 cells a lane as 16-byte words into registers; a
//   band's rows are loaded together, which keeps several loads in flight.
//   The sums stay in registers and end in one warp reduction each
//   (__reduce_add_sync); uint32 addition is order-free, so any order gives
//   the bits of the sequential sum. Lane r stores row r of the band.
// - The column's part of a cell's hash is made once a band: hash mode
//   loads a lane's 16 record hashes once and folds them into every row of
//   the band (the vector crosses L2 N / kBand times instead of N times);
//   id-view mode computes mix32(j ^ 0x9E3779B9) once a band.
// - The state's `> 0` test runs on 4 cells a word (a byte mask; the count
//   is its popcount); each cell's hash is computed unconditionally and
//   masked with one prmt, so no branch breaks up the hashes' overlap.
// - kBand and kWarps are the fastest of scripts/row_kernels_ab.py --probes.
//   Rows that are not 16-byte aligned, or N % 16 != 0, take a scalar route
//   (one cell a lane) with the same bands and reductions.
#include "common.cuh"

namespace {

using namespace kb;

constexpr int kWarps = 4;  // warps per block
// Rows a warp owns: kBand for rows of kLongN cells or more, else one (a
// short row needs the warps more than the shared column work).
constexpr int kBand = 4;
constexpr int kLongN = 4096;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The column's half of the record hash: h(i, j) = mix32(column_hash(j) ^ id).
__device__ __forceinline__ uint32_t column_hash(uint32_t j) { return mix32(j ^ 0x9E3779B9u); }

// All ones where byte b of m has its top bit set, else zero (one prmt: the
// selector's sign mode replicates that bit over every byte).
__device__ __forceinline__ uint32_t byte_sign_mask(uint32_t m, int b) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(m), "r"(0x8888 | 0x1111 * b));
  return r;
}

// Add the hashes h(c) of a lane's member cells among 16 to acc, and their
// number to members. h is computed for every cell and masked, so no branch
// stands between the hashes of neighbouring cells.
template <typename H>
__device__ __forceinline__ void fold16(const Words<int8_t>& s, H h, uint32_t& acc, int& members) {
#pragma unroll
  for (int w = 0; w < kCells / 4; ++w) {
    const unsigned m = bytes_positive(s.word(w));
    members += __popc(m);
#pragma unroll
    for (int b = 0; b < 4; ++b) acc += h(4 * w + b) & byte_sign_mask(m, b);
  }
}

// One warp a band of R rows. The column's part of each cell's hash (the
// record hash in hash mode, column_hash in id-view mode) is made once a
// band and folded into all R rows.
template <bool kIdv, int R>
__global__ void __launch_bounds__(kWarps * 32)
fused_fp_kernel(const int8_t* __restrict__ state, const uint32_t* __restrict__ ident,
                uint32_t* __restrict__ fp, int32_t* __restrict__ cnt, int n_rows, int n,
                int vec) {
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * R;
  if (row0 >= n_rows) return;  // the whole warp: nothing below waits on the block
  const int rows = min(R, n_rows - row0);
  const int8_t* sband = state + static_cast<size_t>(row0) * n;
  const uint32_t* iband = ident + (kIdv ? static_cast<size_t>(row0) * n : 0);
  uint32_t acc[R];
  int members[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0, members[r] = 0;
  if (vec) {
    for (int j0 = lane * kCells; j0 < n; j0 += kChunk) {
      Words<int8_t> s[R];
      Words<uint32_t> id[kIdv ? R : 1];  // id-view rows, or the record hashes
      if constexpr (!kIdv) id[0].load(ident, n, j0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          s[r].load(sband + static_cast<size_t>(r) * n, n, j0);
          if constexpr (kIdv) id[r].load(iband + static_cast<size_t>(r) * n, n, j0);
        }
      }
      uint32_t col[kIdv ? kCells : 1];
      if constexpr (kIdv) {
#pragma unroll
        for (int c = 0; c < kCells; ++c) col[c] = column_hash(j0 + c);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          fold16(s[r], [&](int c) {
            if constexpr (kIdv) return mix32(col[c] ^ id[r].word(c));
            else return id[0].word(c);
          }, acc[r], members[r]);
        }
      }
    }
  } else {
    for (int j = lane; j < n; j += 32) {
      const uint32_t col = kIdv ? column_hash(j) : ident[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows && sband[static_cast<size_t>(r) * n + j] > 0) {
          acc[r] += kIdv ? mix32(col ^ iband[static_cast<size_t>(r) * n + j]) : col;
          ++members[r];
        }
      }
    }
  }
  // Lane r stores row row0 + r: one coalesced store of the band.
  uint32_t my_fp = 0;
  int my_cnt = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t f = __reduce_add_sync(kFull, acc[r]);
    const int c = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(members[r])));
    if (lane == r) my_fp = f, my_cnt = c;
  }
  if (lane < rows) {
    fp[row0 + lane] = my_fp;
    cnt[row0 + lane] = my_cnt;
  }
}

// Rows a warp owns at n.
int band(int n) { return n < kLongN ? 1 : kBand; }

template <bool kIdv>
void launch(const int8_t* s, const uint32_t* id, uint32_t* f, int32_t* c, int n_rows, int n,
            int vec, int blocks, int threads, cudaStream_t st) {
  if (band(n) == 1) {
    fused_fp_kernel<kIdv, 1><<<blocks, threads, 0, st>>>(s, id, f, c, n_rows, n, vec);
  } else {
    fused_fp_kernel<kIdv, kBand><<<blocks, threads, 0, st>>>(s, id, f, c, n_rows, n, vec);
  }
}

// The grid and block of a launch over n_rows rows of n cells.
void rows_shape(int n_rows, int n, int* blocks, int* threads) {
  const int rows_per_block = kWarps * band(n);
  *blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  *threads = kWarps * 32;
}

}  // namespace

// The grid and block of a launch at n (for the launch floor).
extern "C" void kb_launch_shape(int n, int* blocks, int* threads) {
  rows_shape(n, n, blocks, threads);
}

// state int8 [n_rows, n] (a whole mesh, or a rank's rows of one); ident
// uint32 [n_rows, n] (idv != 0) or uint32 [n] record hashes; outputs fp
// uint32 [n_rows], cnt int32 [n_rows]. Returns cudaGetLastError().
extern "C" int kb_fused_fp(const void* state, const void* ident, void* fp, void* cnt,
                           int n_rows, int n, int idv, int vec, void* stream) {
  if (n_rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int blocks, threads;
  rows_shape(n_rows, n, &blocks, &threads);
  const auto* s = static_cast<const int8_t*>(state);
  const auto* id = static_cast<const uint32_t*>(ident);
  auto* f = static_cast<uint32_t*>(fp);
  auto* c = static_cast<int32_t*>(cnt);
  auto st = static_cast<cudaStream_t>(stream);
  if (idv) {
    launch<true>(s, id, f, c, n_rows, n, vec, blocks, threads, st);
  } else {
    launch<false>(s, id, f, c, n_rows, n, vec, blocks, threads, st);
  }
  return static_cast<int>(cudaGetLastError());
}
