// Fused phase-A row statistics, one row per block.
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
// Bound: bytes. One read of the state row (1 byte a cell) and, on an alive
// row, the timer row (2 or 4 bytes a cell) feeds a few compares per cell.
// Every output that reads a timer (jstar, has_timed, has_timed_wfip) is
// gated on alive[i], so a dead row reads its state row only. The design
// reads the rows once with 16-byte loads and folds all five statistics
// into registers in the same pass; the (timer, j) argmin is one min over a
// packed 64-bit key (timer in the high word, j in the low), so a single
// block-wide min reduction gives the Pallas kernel's two-stage min (min
// timer, then min j at that timer) exactly.
#include "common.cuh"

namespace {

constexpr int kKnown = 1;
constexpr int kWaitingForPing = 2;
constexpr int kWaitingForIndirectPing = 3;

struct SuspicionAcc {
  int count = 0;
  long long best = LLONG_MAX;
  int cand = 0;
  int wfip = 0;

  // kAlive: the row is alive, so its timer t is read and aged cells count.
  template <bool kAlive>
  __device__ __forceinline__ void visit(int row, int j, int s, int t, int thr) {
    count += s > 0;
    cand |= (s == kKnown) & (j != row);
    if constexpr (kAlive) {
      const bool aged = t <= thr;
      if (aged && s == kWaitingForPing) best = min(best, lex_key(t, j));
      wfip |= aged & (s == kWaitingForIndirectPing);
    }
  }
};

// Fold one row into acc; a dead row (kAlive false) never loads its timers.
template <typename TT, bool kAlive>
__device__ __forceinline__ void scan_row(const int8_t* __restrict__ srow,
                                         const TT* __restrict__ trow, int row, int n, int vec,
                                         int thr, SuspicionAcc& acc) {
  if (vec) {
    for (int v = threadIdx.x; v < n / 16; v += blockDim.x) {
      alignas(16) int8_t s[16];
      alignas(16) TT t[16];
      load16(srow + 16 * v, s);
      if constexpr (kAlive) load16(trow + 16 * v, t);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        acc.visit<kAlive>(row, 16 * v + k, s[k], kAlive ? static_cast<int>(t[k]) : 0, thr);
      }
    }
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      acc.visit<kAlive>(row, j, srow[j], kAlive ? static_cast<int>(trow[j]) : 0, thr);
    }
  }
}

template <typename TT>
__global__ void __launch_bounds__(KB_THREADS)
fused_suspicion_kernel(const int8_t* __restrict__ state, const TT* __restrict__ timer,
                       const uint8_t* __restrict__ alive, int thr,
                       int32_t* __restrict__ cnt, int32_t* __restrict__ jstar,
                       uint8_t* __restrict__ has_timed, uint8_t* __restrict__ has_cand,
                       uint8_t* __restrict__ has_wfip, int n, int vec) {
  const int row = blockIdx.x;
  const int8_t* srow = state + static_cast<size_t>(row) * n;
  const TT* trow = timer + static_cast<size_t>(row) * n;
  SuspicionAcc acc;
  if (alive[row] != 0) {
    scan_row<TT, true>(srow, trow, row, n, vec, thr, acc);
  } else {
    scan_row<TT, false>(srow, trow, row, n, vec, thr, acc);
  }
  const int count = block_reduce(acc.count, SumOp(), 0);
  const long long best = block_reduce(acc.best, MinOp(), LLONG_MAX);
  const int cand = block_reduce(acc.cand, MaxOp(), 0);
  const int wfip = block_reduce(acc.wfip, MaxOp(), 0);
  if (threadIdx.x == 0) {
    const bool timed = best != LLONG_MAX;
    cnt[row] = count;
    jstar[row] = timed ? static_cast<int>(best & 0xFFFFFFFFLL) : -1;
    has_timed[row] = timed;
    has_cand[row] = cand != 0;
    has_wfip[row] = wfip != 0;
  }
}

}  // namespace

// state int8 [n, n]; timer int16 (timer_bytes 2) or int32 (4) [n, n];
// alive bool [n]; outputs int32 [n] x2, bool [n] x3.
extern "C" int kb_fused_suspicion(const void* state, const void* timer, int timer_bytes,
                                  const void* alive, int thr, void* cnt, void* jstar,
                                  void* has_timed, void* has_cand, void* has_wfip,
                                  int n, int vec, void* stream) {
  if (n <= 0 || (timer_bytes != 2 && timer_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* s = static_cast<const int8_t*>(state);
  const auto* a = static_cast<const uint8_t*>(alive);
  auto* c = static_cast<int32_t*>(cnt);
  auto* js = static_cast<int32_t*>(jstar);
  auto* ht = static_cast<uint8_t*>(has_timed);
  auto* hc = static_cast<uint8_t*>(has_cand);
  auto* hw = static_cast<uint8_t*>(has_wfip);
  auto st = static_cast<cudaStream_t>(stream);
  if (timer_bytes == 2) {
    fused_suspicion_kernel<int16_t><<<n, KB_THREADS, 0, st>>>(
        s, static_cast<const int16_t*>(timer), a, thr, c, js, ht, hc, hw, n, vec);
  } else {
    fused_suspicion_kernel<int32_t><<<n, KB_THREADS, 0, st>>>(
        s, static_cast<const int32_t*>(timer), a, thr, c, js, ht, hc, hw, n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
