// Fused phase-A row statistics: one warp owns a row.
//
// Replaces the Pallas kernel kaboodle_tpu/ops/fused_suspicion.py::
// fused_suspicion (pallas_call at fused_suspicion.py:119, body _make_kernel
// at :36-76). Per row i, with thr = t - ping_timeout_ticks:
//
//   count[i]          = |{j : state[i,j] > 0}|
//   jstar[i]          = the lexicographically smallest (timer, j) over the
//                       cells alive[i] & state == WAITING_FOR_PING &
//                       timer <= thr, or -1 when there is none
//   has_timed[i]      = that set is not empty
//   has_cand[i]       = some cell state == KNOWN with j != i
//   has_timed_wfip[i] = some cell alive[i] & state == WAITING_FOR_INDIRECT_PING
//                       & timer <= thr
//
// Bound: bytes. The function must read the state row (1 byte a cell) and,
// on an alive row, the timer row (2 or 4 bytes a cell); every output that
// reads a timer is gated on alive[i], so a dead row reads its state row
// only. Per cell it needs about ten integer operations, under the bytes'
// time at N = 8,192 and 16,384 but not by much. At N = 1,024 a row is 5 KB
// and an empty launch of the same grid is half the kernel's time, so the
// design keeps the chain from launch to the last store short and takes the
// per-cell work down:
//
// - One warp owns a row, a block holds kRows rows: no shared memory, no
//   block barrier. The row streams in 512-cell chunks, 16 cells a lane as
//   16-byte words straight into registers, kDepthShort or kDepthLong
//   chunks' loads issued before the first is folded (a 1,024-cell row is
//   two chunks: all its loads are in flight at once). The depths and rows
//   a block are the fastest of scripts/row_kernels_ab.py --probes.
// - The state tests run on 4 cells a word: the count, KNOWN,
//   WAITING_FOR_PING and WAITING_FOR_INDIRECT_PING are byte masks (the
//   count their popcount); only the two timer folds below are per cell.
// - The aged test leaves the cell loop. The smallest (timer, j) over a
//   row's WAITING_FOR_PING cells is aged iff its timer is <= thr, and is
//   then the smallest aged one too; has_timed_wfip is "the smallest timer
//   over WAITING_FOR_INDIRECT_PING cells is <= thr". A lane folds each
//   chunk from its highest column down with `<=` (a tie keeps the lowest
//   column) and merges chunks in column order; the warp ends with five
//   single-instruction reductions: the count (sum), the lowest timer, the
//   lowest column at that timer, the lowest indirect timer (min) and the
//   flags (or). Nothing is 64-bit, and no sentinel can pass for a cell:
//   "the row has such a cell" travels as a flag.
// - Rows that are not 16-byte aligned, or N % 16 != 0, take a scalar route
//   (one cell a lane) with the same per-lane state and reductions.
#include "common.cuh"

namespace {

using namespace kb;

constexpr int kKnown = 1;
constexpr int kWaitingForPing = 2;
constexpr int kWaitingForIndirectPing = 3;
constexpr int kRows = 8;  // rows per block, one warp each
// Chunks whose loads are issued before the first is folded: kDepthShort
// for rows shorter than kLongN cells (a 1,024-cell row is two chunks, all
// in flight at once), kDepthLong for longer ones.
constexpr int kDepthShort = 2;
constexpr int kDepthLong = 4;
constexpr int kLongN = 4096;

// Flags of a lane, OR-ed over the warp.
constexpr unsigned kCand = 1;    // a KNOWN cell off the diagonal
constexpr unsigned kAnyWfp = 2;  // a WAITING_FOR_PING cell
constexpr unsigned kAnyWfip = 4; // a WAITING_FOR_INDIRECT_PING cell

struct Acc {
  int count = 0;
  unsigned known = 0, wfp = 0, wfip = 0;  // OR of byte-test words (or of cells)
  int wfp_t = INT_MAX;                    // lowest WAITING_FOR_PING timer seen
  int wfp_j = INT_MAX;                    // its lowest column
  int wfip_t = INT_MAX;                   // lowest WAITING_FOR_INDIRECT_PING timer

  __device__ __forceinline__ unsigned flags() const {
    return (known != 0 ? kCand : 0u) | (wfp != 0 ? kAnyWfp : 0u) |
           (wfip != 0 ? kAnyWfip : 0u);
  }
};

// One lane's share of a chunk: its 16 state cells and, on an alive row,
// their timers.
template <typename TT, bool kAlive>
struct Chunk {
  Words<int8_t> s;
  Words<TT> t;

  __device__ __forceinline__ void load(const int8_t* __restrict__ srow,
                                       const TT* __restrict__ trow, int n, int j0) {
    s.load(srow, n, j0);
    if constexpr (kAlive) t.load(trow, n, j0);
  }

  // Fold the chunk's cells (columns j0 .. j0 + 15) into acc.
  __device__ __forceinline__ void fold(int row, int j0, Acc& acc) const {
    const unsigned diag = static_cast<unsigned>(row - j0);  // < 16 on the diagonal's chunk
    unsigned m2[kCells / 4], m3[kCells / 4];
#pragma unroll
    for (int w = 0; w < kCells / 4; ++w) {
      const unsigned sw = s.word(w);
      acc.count += __popc(bytes_positive(sw));
      unsigned known = bytes_equal(sw, kKnown);
      if (diag - 4 * w < 4) known &= ~(0x80u << (8 * (diag - 4 * w)));
      acc.known |= known;
      m2[w] = bytes_equal(sw, kWaitingForPing);
      m3[w] = bytes_equal(sw, kWaitingForIndirectPing);
    }
    if constexpr (kAlive) {
      // The chunk's lowest WAITING_FOR_PING (timer, j): the cells go from the
      // highest column down, so `<=` leaves the lowest column of a tie (and
      // takes a timer at INT_MAX).
      int lt = INT_MAX, lj = INT_MAX;
#pragma unroll
      for (int c = kCells - 1; c >= 0; --c) {
        const int tc = t.at(c);
        if (cell_bit(m2[c / 4], c) && tc <= lt) {
          lt = tc;
          lj = j0 + c;
        }
        if (cell_bit(m3[c / 4], c)) acc.wfip_t = min(acc.wfip_t, tc);
      }
#pragma unroll
      for (int w = 0; w < kCells / 4; ++w) {
        acc.wfp |= m2[w];
        acc.wfip |= m3[w];
      }
      if (lt < acc.wfp_t || (lt == acc.wfp_t && lj < acc.wfp_j)) {
        acc.wfp_t = lt;
        acc.wfp_j = lj;
      }
    }
  }
};

// Fold a row, D chunks' loads at a time; a dead row (kAlive false) loads no
// timer.
template <typename TT, bool kAlive, int D>
__device__ __forceinline__ void scan_vec(const int8_t* __restrict__ srow,
                                         const TT* __restrict__ trow, int n, int row, int lane,
                                         Acc& acc) {
  for (int q = 0; q * kChunk < n; q += D) {
    Chunk<TT, kAlive> ch[D];
#pragma unroll
    for (int d = 0; d < D; ++d) ch[d].load(srow, trow, n, (q + d) * kChunk + lane * kCells);
#pragma unroll
    for (int d = 0; d < D; ++d) ch[d].fold(row, (q + d) * kChunk + lane * kCells, acc);
  }
}

template <typename TT, bool kAlive>
__device__ __forceinline__ void scan_scalar(const int8_t* __restrict__ srow,
                                            const TT* __restrict__ trow, int n, int row,
                                            int lane, Acc& acc) {
  for (int j = lane; j < n; j += 32) {
    const int s = srow[j];
    acc.count += s > 0;
    acc.known |= (s == kKnown) & (j != row);
    if constexpr (kAlive) {
      if (s == kWaitingForPing) {
        acc.wfp = 1;
        const int tc = trow[j];
        if (tc < acc.wfp_t || acc.wfp_j == INT_MAX) {  // j rises: a tie keeps the first
          acc.wfp_t = tc;
          acc.wfp_j = j;
        }
      } else if (s == kWaitingForIndirectPing) {
        acc.wfip = 1;
        acc.wfip_t = min(acc.wfip_t, static_cast<int>(trow[j]));
      }
    }
  }
}

template <typename TT, int D>
__global__ void __launch_bounds__(kRows * 32)
fused_suspicion_kernel(const int8_t* __restrict__ state, const TT* __restrict__ timer,
                       const uint8_t* __restrict__ alive, int thr,
                       int32_t* __restrict__ cnt, int32_t* __restrict__ jstar,
                       uint8_t* __restrict__ has_timed, uint8_t* __restrict__ has_cand,
                       uint8_t* __restrict__ has_wfip, int n_rows, int row0, int n, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp: nothing below waits on the block
  const int8_t* srow = state + static_cast<size_t>(row) * n;
  const TT* trow = timer + static_cast<size_t>(row) * n;
  const bool live = alive[row] != 0;
  const int diag = row0 + row;  // the row's own column: its peer index
  Acc acc;
  if (vec) {
    if (live) scan_vec<TT, true, D>(srow, trow, n, diag, lane, acc);
    else scan_vec<TT, false, D>(srow, trow, n, diag, lane, acc);
  } else {
    if (live) scan_scalar<TT, true>(srow, trow, n, diag, lane, acc);
    else scan_scalar<TT, false>(srow, trow, n, diag, lane, acc);
  }
  const int count = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(acc.count)));
  const unsigned flags = __reduce_or_sync(kFull, acc.flags());
  const int t_min = __reduce_min_sync(kFull, acc.wfp_t);
  const unsigned j_min =
      __reduce_min_sync(kFull, acc.wfp_t == t_min ? static_cast<unsigned>(acc.wfp_j) : ~0u);
  const int wfip_min = __reduce_min_sync(kFull, acc.wfip_t);
  if (lane == 0) {
    const bool timed = (flags & kAnyWfp) && t_min <= thr;  // a dead row has no flag
    cnt[row] = count;
    jstar[row] = timed ? static_cast<int>(j_min) : -1;
    has_timed[row] = timed;
    has_cand[row] = (flags & kCand) != 0;
    has_wfip[row] = (flags & kAnyWfip) && wfip_min <= thr;
  }
}

template <typename TT>
void launch(const int8_t* s, const void* timer, const uint8_t* a, int thr, int32_t* c,
            int32_t* js, uint8_t* ht, uint8_t* hc, uint8_t* hw, int n_rows, int row0, int n,
            int vec, int blocks, int threads, cudaStream_t st) {
  const auto* t = static_cast<const TT*>(timer);
  if (n < kLongN) {
    fused_suspicion_kernel<TT, kDepthShort><<<blocks, threads, 0, st>>>(
        s, t, a, thr, c, js, ht, hc, hw, n_rows, row0, n, vec);
  } else {
    fused_suspicion_kernel<TT, kDepthLong><<<blocks, threads, 0, st>>>(
        s, t, a, thr, c, js, ht, hc, hw, n_rows, row0, n, vec);
  }
}

}  // namespace

// The grid and block of a launch at n (for the launch floor).
extern "C" void kb_launch_shape(int n, int* blocks, int* threads) {
  *blocks = (n + kRows - 1) / kRows;
  *threads = kRows * 32;
}

// state int8 [n_rows, n]; timer int16 (timer_bytes 2) or int32 (4)
// [n_rows, n]: rows row0 .. row0 + n_rows - 1 of a mesh of n peers (all of
// it with row0 0 and n_rows n); alive bool [n_rows]; outputs int32
// [n_rows] x2, bool [n_rows] x3.
extern "C" int kb_fused_suspicion(const void* state, const void* timer, int timer_bytes,
                                  const void* alive, int thr, void* cnt, void* jstar,
                                  void* has_timed, void* has_cand, void* has_wfip,
                                  int n_rows, int row0, int n, int vec, void* stream) {
  if (n_rows <= 0 || n <= 0 || row0 < 0 || row0 + n_rows > n ||
      (timer_bytes != 2 && timer_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks, threads;
  kb_launch_shape(n_rows, &blocks, &threads);
  const auto* s = static_cast<const int8_t*>(state);
  const auto* a = static_cast<const uint8_t*>(alive);
  auto* c = static_cast<int32_t*>(cnt);
  auto* js = static_cast<int32_t*>(jstar);
  auto* ht = static_cast<uint8_t*>(has_timed);
  auto* hc = static_cast<uint8_t*>(has_cand);
  auto* hw = static_cast<uint8_t*>(has_wfip);
  auto st = static_cast<cudaStream_t>(stream);
  if (timer_bytes == 2) {
    launch<int16_t>(s, timer, a, thr, c, js, ht, hc, hw, n_rows, row0, n, vec, blocks,
                    threads, st);
  } else {
    launch<int32_t>(s, timer, a, thr, c, js, ht, hc, hw, n_rows, row0, n, vec, blocks,
                    threads, st);
  }
  return static_cast<int>(cudaGetLastError());
}
