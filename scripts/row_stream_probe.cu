// Load patterns for streaming [N, N] rows of state (int8) and timers
// (int16 or int32), with nothing else in the kernel: each lane folds the
// words it loads into one register, written out so the loads stay. Built
// and timed by scripts/row_stream_probe.py; no kernel of the port runs it.
//
//   ring_*  one warp a row, 16-byte cp.async copies into a shared-memory
//           ring of S stages per warp (W warps a block)
//   ahead_* one warp a row, 16-byte loads straight into registers, D
//           chunks of 512 cells loaded before the first is used
//   block   one 256-thread block a row, 16-byte loads (the K1-K3 pattern)
//
// Dead rows read nothing, as in K4. Needs N % 16 == 0 and 16-byte aligned
// rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned fold(int4 v) { return v.x ^ v.y ^ v.z ^ v.w; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename TT, int W, int S>
__global__ void __launch_bounds__(W * 32)
ring(const int8_t* st, const TT* tm, const uint8_t* alive, unsigned* out, int n) {
  constexpr int kWords = sizeof(TT);  // timer words of 16 cells
  __shared__ int4 ss[W][S][32];
  __shared__ int4 ts[W][S][kWords][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, row = blockIdx.x * W + w;
  if (row >= n) return;
  unsigned acc = 0;
  if (alive[row]) {
    const int8_t* s = st + static_cast<size_t>(row) * n;
    const TT* t = tm + static_cast<size_t>(row) * n;
    const int nq = (n + 511) / 512;
    auto fetch = [&](int q) {
      const int j0 = q * 512 + lane * 16;
      if (q < nq && j0 < n) {
        cp_async16(&ss[w][q % S][lane], s + j0);
        for (int v = 0; v < kWords; ++v) cp_async16(&ts[w][q % S][v][lane], t + j0 + v * (16 / sizeof(TT)));
      }
      cp_async_commit();
    };
    for (int q = 0; q < S - 1; ++q) fetch(q);
    for (int q = 0; q < nq; ++q) {
      cp_async_wait<S - 2>();
      acc ^= fold(ss[w][q % S][lane]);
      for (int v = 0; v < kWords; ++v) acc ^= fold(ts[w][q % S][v][lane]);
      fetch(q + S - 1);
    }
    cp_async_wait<0>();
  }
  out[row * 32 + lane] = acc;
}

template <typename TT, int D>
__global__ void __launch_bounds__(128)
ahead(const int8_t* st, const TT* tm, const uint8_t* alive, unsigned* out, int n) {
  constexpr int kWords = sizeof(TT);
  const int lane = threadIdx.x & 31, row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= n) return;
  unsigned acc = 0;
  if (alive[row]) {
    const int4* s = reinterpret_cast<const int4*>(st + static_cast<size_t>(row) * n);
    const int4* t = reinterpret_cast<const int4*>(tm + static_cast<size_t>(row) * n);
    const int nv = n / 16;
    for (int v0 = 0; v0 < nv; v0 += 32 * D) {
      int4 a[D], b[D][kWords];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int v = v0 + 32 * d + lane;
        a[d] = v < nv ? __ldg(s + v) : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int u = 0; u < kWords; ++u) {
          b[d][u] = v < nv ? __ldg(t + kWords * v + u) : make_int4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc ^= fold(a[d]);
#pragma unroll
        for (int u = 0; u < kWords; ++u) acc ^= fold(b[d][u]);
      }
    }
  }
  out[row * 32 + lane] = acc;
}

template <typename TT>
__global__ void __launch_bounds__(256)
block(const int8_t* st, const TT* tm, const uint8_t* alive, unsigned* out, int n) {
  constexpr int kWords = sizeof(TT);
  const int row = blockIdx.x;
  unsigned acc = 0;
  if (alive[row]) {
    const int4* s = reinterpret_cast<const int4*>(st + static_cast<size_t>(row) * n);
    const int4* t = reinterpret_cast<const int4*>(tm + static_cast<size_t>(row) * n);
    for (int v = threadIdx.x; v < n / 16; v += 256) {
      acc ^= fold(__ldg(s + v));
      for (int u = 0; u < kWords; ++u) acc ^= fold(__ldg(t + kWords * v + u));
    }
  }
  if (threadIdx.x < 32) out[row * 32 + threadIdx.x] = acc;
}

template <typename TT>
int run(int pattern, const void* s, const void* t, const uint8_t* a, unsigned* o, int n,
        cudaStream_t st) {
  const auto* sp = static_cast<const int8_t*>(s);
  const auto* tp = static_cast<const TT*>(t);
  const int g4 = (n + 3) / 4;
  switch (pattern) {
    case 0: ring<TT, 4, 4><<<g4, 128, 0, st>>>(sp, tp, a, o, n); break;
    case 1: ring<TT, 4, 2><<<g4, 128, 0, st>>>(sp, tp, a, o, n); break;
    case 2: ahead<TT, 1><<<g4, 128, 0, st>>>(sp, tp, a, o, n); break;
    case 3: ahead<TT, 2><<<g4, 128, 0, st>>>(sp, tp, a, o, n); break;
    case 4: ahead<TT, 4><<<g4, 128, 0, st>>>(sp, tp, a, o, n); break;
    case 5: block<TT><<<n, 256, 0, st>>>(sp, tp, a, o, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pattern: 0 ring_w4_s4, 1 ring_w4_s2, 2 ahead_d1, 3 ahead_d2, 4 ahead_d4, 5 block.
// out: uint32 [n, 32].
extern "C" int kb_row_stream(int pattern, const void* state, const void* timer, int timer_bytes,
                             const void* alive, void* out, int n, void* stream) {
  const auto* a = static_cast<const uint8_t*>(alive);
  auto* o = static_cast<unsigned*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (timer_bytes == 2) return run<int16_t>(pattern, state, timer, a, o, n, st);
  return run<int32_t>(pattern, state, timer, a, o, n, st);
}
