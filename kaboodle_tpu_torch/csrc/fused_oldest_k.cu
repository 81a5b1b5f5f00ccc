// Fused oldest-k ping-target candidates: one warp owns a row.
//
// Replaces the Pallas kernel kaboodle_tpu/ops/fused_oldest_k.py::
// fused_oldest_k (pallas_call at fused_oldest_k.py:119, body _make_kernel
// at :39-73). Per row i, over the eligible cells
//
//   alive[i] & state[i,j] == KNOWN & j != i & timer[i,j] != max(timer dtype)
//
// it returns the k lexicographically smallest (timer, j) in order: idx[i, r]
// is the r-th one's column (n - 1 in a slot with no candidate) and
// valid[i, r] whether it exists. Any k >= 1.
//
// Bound: bytes. The function must read each alive row once (1 byte of state
// and 2 or 4 of timer a cell) and write 5 bytes a slot; a dead row has no
// eligible cell and reads nothing. Per cell it needs a handful of integer
// operations, far below the card's int32 rate, so the design keeps the loads
// in flight and takes the per-cell branch out of their way:
//
// - Warp-level row ownership. A block of kWarps warps holds kWarps rows, one
//   warp each. The warp keeps its sorted candidate list spread over its
//   lanes (lane r holds the rank-r key), so there is no block barrier, no
//   shared memory and no final merge: the list is the answer.
// - Loads straight into registers. The row streams in chunks of 512 cells,
//   16 a lane in 16-byte words; the warps resident on an SM (no shared
//   memory, 40-56 registers a thread) keep enough loads in flight. Staging
//   through a shared-memory ring of 16-byte cp.async copies streamed slower
//   on the H100, and starting the next chunk's loads before the current one
//   is filtered gained nothing (scripts/row_stream_probe.py,
//   scripts/oldest_k_ab.py --probes). Rows that are not 16-byte aligned,
//   or N % 16 != 0, take a scalar route with the same filter and list.
// - Filter, then insert. Each cell is tested against the warp-uniform
//   threshold, the list's current last key. Only cells below it go to the
//   ballot loop, which inserts them one at a time (one ballot, one popc and
//   one shuffle-up) and re-filters the rest against the tightened
//   threshold. A row of random timers inserts about k (1 + ln(m / k)) of its
//   m eligible cells, nearly all in its first chunk; ties break toward the
//   lower column, which the column-order stream reaches first.
// - 32-bit keys where they fit: an int16 timer and a column below 65,536
//   pack into ((t + 0x8000) << 16) | j, whose unsigned order is the
//   lexicographic order. Int32 timers use the 64-bit (t ^ 2^31) << 32 | j.
//   A timer at its dtype's max is never eligible, so the all-ones key is a
//   free "empty" sentinel.
// - Any k. A round finds up to 32 slots; k > 32 runs ceil(k / 32) rounds
//   over the row, each keeping only the keys above the previous round's
//   last one, so the list never leaves the registers and needs no memory
//   that grows with k. A round that ends short of its width means the row
//   is exhausted, and the remaining slots are written empty.
#include "common.cuh"

namespace {

constexpr int kKnown = 1;
constexpr int kWarps = 4;            // rows per block, one warp each
constexpr int kCells = 16;           // cells per lane per chunk (16 bytes of state)
constexpr int kChunk = 32 * kCells;  // cells per warp per chunk
constexpr unsigned kFull = 0xffffffffu;

template <typename K>
__device__ __forceinline__ K make_key(int t, int j) {
  if constexpr (sizeof(K) == 4) {
    return ((static_cast<unsigned>(t) + 0x8000u) << 16) | static_cast<unsigned>(j);
  } else {
    return (static_cast<unsigned long long>(static_cast<unsigned>(t) ^ 0x80000000u) << 32) |
           static_cast<unsigned>(j);
  }
}

template <typename K>
__device__ __forceinline__ int key_col(K key) {
  return static_cast<int>(key & (sizeof(K) == 4 ? 0xFFFFu : 0xFFFFFFFFu));
}

// The warp's sorted list of its w smallest keys so far: lane r < w holds
// the rank-r key, every other lane the empty key. `thr` (the rank-(w-1)
// key, uniform over the warp) is the bar a new key must be under.
template <typename K>
struct WarpList {
  static constexpr K kEmpty = ~K(0);
  K l = kEmpty;
  K thr = kEmpty;
  int w;

  // Insert the warp-uniform key x < thr: lanes at and above its rank move
  // up one.
  __device__ __forceinline__ void insert(K x, int lane) {
    const int pos = __popc(__ballot_sync(kFull, l < x));
    const K up = __shfl_up_sync(kFull, l, 1);
    if (lane < w && lane >= pos) l = lane == pos ? x : up;
    thr = __shfl_sync(kFull, l, w - 1);
  }
};

// Offer each lane's candidate cells (bit c of `bits` for key[c]) to the
// list, lowest lane first, dropping every cell the tightened bar excludes.
template <typename K, int NC>
__device__ __forceinline__ void offer(const K (&key)[NC], unsigned bits, WarpList<K>& wl,
                                      int lane) {
  if (!__any_sync(kFull, bits != 0)) return;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    unsigned m = __ballot_sync(kFull, ((bits >> c) & 1u) && key[c] < wl.thr);
    while (m) {
      wl.insert(__shfl_sync(kFull, key[c], __ffs(m) - 1), lane);
      m &= (m - 1) & __ballot_sync(kFull, key[c] < wl.thr);
    }
  }
}

// A cell's test: eligible, under the bar, and (after the first round) at
// or above the round's lower bound.
template <typename K, bool kLo>
__device__ __forceinline__ bool passes(int s, int t, K key, int tmax, K lo, K thr) {
  return s == kKnown && t != tmax && key < thr && (!kLo || key >= lo);
}

// One chunk of a lane's cells as loaded: 16 state bytes and the timer words.
template <typename TT>
struct Chunk {
  static constexpr int kWords = kCells * sizeof(TT) / 16;
  int4 s;
  int4 t[kWords];
};

// Lane `lane`'s cells of chunk q (none past the row's end).
template <typename TT>
__device__ __forceinline__ Chunk<TT> load_chunk(const int8_t* __restrict__ srow,
                                                const TT* __restrict__ trow, int n, int q,
                                                int lane) {
  Chunk<TT> c{};
  const int j0 = q * kChunk + lane * kCells;
  if (j0 < n) {
    c.s = __ldg(reinterpret_cast<const int4*>(srow + j0));
#pragma unroll
    for (int w = 0; w < Chunk<TT>::kWords; ++w) {
      c.t[w] = __ldg(reinterpret_cast<const int4*>(trow + j0) + w);
    }
  }
  return c;
}

// Filter one chunk against the bar and offer the cells that pass.
template <typename TT, typename K, bool kLo>
__device__ __forceinline__ void take_chunk(const Chunk<TT>& ch, int q, int n, int row, int tmax,
                                           K lo, WarpList<K>& wl, int lane) {
  const int j0 = q * kChunk + lane * kCells;
  alignas(16) int8_t sv[kCells];
  alignas(16) TT tv[kCells];
  *reinterpret_cast<int4*>(sv) = ch.s;
#pragma unroll
  for (int w = 0; w < Chunk<TT>::kWords; ++w) reinterpret_cast<int4*>(tv)[w] = ch.t[w];
  K key[kCells];
  unsigned bits = 0;
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int t = tv[c];
    key[c] = make_key<K>(t, j0 + c);
    bits |= static_cast<unsigned>(j0 < n && passes<K, kLo>(sv[c], t, key[c], tmax, lo, wl.thr))
            << c;
  }
  if (static_cast<unsigned>(row - j0) < static_cast<unsigned>(kCells)) {
    bits &= ~(1u << (row - j0));
  }
  offer(key, bits, wl, lane);
}

// One round over a row whose cells load in 16-byte words.
template <typename TT, typename K, bool kLo>
__device__ void scan_vec(const int8_t* __restrict__ srow, const TT* __restrict__ trow, int n,
                         int row, int tmax, K lo, WarpList<K>& wl, int lane) {
  const int nchunks = (n + kChunk - 1) / kChunk;
  for (int q = 0; q < nchunks; ++q) {
    take_chunk<TT, K, kLo>(load_chunk(srow, trow, n, q, lane), q, n, row, tmax, lo, wl, lane);
  }
}

// One round over a row read one cell a lane at a time.
template <typename TT, typename K, bool kLo>
__device__ void scan_scalar(const int8_t* __restrict__ srow, const TT* __restrict__ trow, int n,
                            int row, int tmax, K lo, WarpList<K>& wl, int lane) {
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    K key[1] = {WarpList<K>::kEmpty};
    unsigned bits = 0;
    if (j < n) {
      const int t = trow[j];
      key[0] = make_key<K>(t, j);
      bits = j != row && passes<K, kLo>(srow[j], t, key[0], tmax, lo, wl.thr);
    }
    offer(key, bits, wl, lane);
  }
}

template <typename TT, typename K>
__global__ void __launch_bounds__(kWarps * 32)
fused_oldest_k_kernel(const int8_t* __restrict__ state, const TT* __restrict__ timer,
                      const uint8_t* __restrict__ alive, int32_t* __restrict__ out_idx,
                      uint8_t* __restrict__ out_valid, int n_rows, int row0, int n, int k,
                      int vec, int tmax) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // the whole warp: nothing below waits on the block
  const int diag = row0 + row;  // the row's own column: its peer index
  const int8_t* srow = state + static_cast<size_t>(row) * n;
  const TT* trow = timer + static_cast<size_t>(row) * n;
  int32_t* irow = out_idx + static_cast<size_t>(row) * k;
  uint8_t* vrow = out_valid + static_cast<size_t>(row) * k;
  bool done = alive[row] == 0;  // a dead row reads nothing
  K lo = 0;
  for (int r0 = 0; r0 < k; r0 += 32) {
    WarpList<K> wl;
    wl.w = min(32, k - r0);
    if (!done) {
      if (vec) {
        if (r0 == 0) scan_vec<TT, K, false>(srow, trow, n, diag, tmax, lo, wl, lane);
        else scan_vec<TT, K, true>(srow, trow, n, diag, tmax, lo, wl, lane);
      } else {
        if (r0 == 0) scan_scalar<TT, K, false>(srow, trow, n, diag, tmax, lo, wl, lane);
        else scan_scalar<TT, K, true>(srow, trow, n, diag, tmax, lo, wl, lane);
      }
      done = wl.thr == WarpList<K>::kEmpty;  // fewer than w found: the row is exhausted
      lo = wl.thr + 1;
    }
    if (lane < wl.w) {
      const bool ok = wl.l != WarpList<K>::kEmpty;
      irow[r0 + lane] = ok ? key_col(wl.l) : n - 1;
      vrow[r0 + lane] = ok;
    }
  }
}

template <typename TT, typename K>
int launch(const void* s, const void* t, const uint8_t* a, int32_t* idx, uint8_t* valid,
           int n_rows, int row0, int n, int k, int vec, int tmax, cudaStream_t st) {
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  fused_oldest_k_kernel<TT, K><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const int8_t*>(s), static_cast<const TT*>(t), a, idx, valid, n_rows, row0, n,
      k, vec, tmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// state int8 [n_rows, n]; timer int16 (timer_bytes 2) or int32 (4)
// [n_rows, n]: rows row0 .. row0 + n_rows - 1 of a mesh of n peers (all of
// it with row0 0 and n_rows n); alive bool [n_rows]; outputs idx int32
// [n_rows, k], valid bool [n_rows, k]; k >= 1.
extern "C" int kb_fused_oldest_k(const void* state, const void* timer, int timer_bytes,
                                 const void* alive, int k, void* idx, void* valid,
                                 int n_rows, int row0, int n, int vec, void* stream) {
  if (n_rows <= 0 || n <= 0 || row0 < 0 || row0 + n_rows > n || k < 1 ||
      (timer_bytes != 2 && timer_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a = static_cast<const uint8_t*>(alive);
  auto* ix = static_cast<int32_t*>(idx);
  auto* va = static_cast<uint8_t*>(valid);
  auto st = static_cast<cudaStream_t>(stream);
  if (timer_bytes == 4) {
    return launch<int32_t, unsigned long long>(state, timer, a, ix, va, n_rows, row0, n, k, vec,
                                               INT32_MAX, st);
  }
  if (n <= 65536) {  // the column fits the key's low 16 bits
    return launch<int16_t, unsigned>(state, timer, a, ix, va, n_rows, row0, n, k, vec, INT16_MAX,
                                     st);
  }
  return launch<int16_t, unsigned long long>(state, timer, a, ix, va, n_rows, row0, n, k, vec,
                                             INT16_MAX, st);
}
