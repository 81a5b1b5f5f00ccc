// Shared pieces of the row kernels: a lane's share of a row chunk, byte
// tests over 4 state cells at once, an empty kernel for the launch floor,
// and the error string of a launch's return code.
//
// Every kernel gives a row (or a band of rows) to one warp: a block holds
// several warps and no warp waits on another, so there is no shared memory
// and no block barrier. A row streams in chunks of 512 cells, 16 a lane,
// loaded as 16-byte words straight into registers (rows 16-byte aligned and
// N % 16 == 0); other rows take a scalar route of one cell a lane. A warp
// ends its row with single-instruction warp reductions (__reduce_*_sync).
#pragma once

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

extern "C" const char* kb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

__global__ void kb_empty_kernel() {}

}  // namespace

// An empty kernel at a kernel's grid and block: what one launch costs on
// the device before any work (the launch floor beside a kernel's bound).
extern "C" int kb_empty_launch(int blocks, int threads, void* stream) {
  kb_empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

namespace kb {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCells = 16;           // cells a lane per chunk: 16 bytes of state
constexpr int kChunk = 32 * kCells;  // cells a warp per chunk

// A lane's kCells elements of a row chunk (columns j0 .. j0 + 15), as
// 16-byte words held in registers; zeros past the row's end, so a state
// chunk there holds no member. Elements are read back by compile-time
// index, which keeps them in registers.
template <typename T>
struct Words {
  static constexpr int kN = kCells * sizeof(T) / 16;
  int4 w[kN];

  __device__ __forceinline__ void load(const T* __restrict__ row, int n, int j0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) w[i] = make_int4(0, 0, 0, 0);
    if (j0 < n) {
#pragma unroll
      for (int i = 0; i < kN; ++i) w[i] = __ldg(reinterpret_cast<const int4*>(row + j0) + i);
    }
  }
  // 32-bit word i: elements i * 4 / sizeof(T) onwards, the lowest first.
  __device__ __forceinline__ unsigned word(int i) const {
    const int4& v = w[i >> 2];
    const int k = i & 3;
    return static_cast<unsigned>(k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w);
  }
  __device__ __forceinline__ int at(int c) const {
    constexpr int kPer = 4 / sizeof(T);
    const unsigned x = word(c / kPer) >> (8 * sizeof(T) * (c % kPer));
    return static_cast<int>(static_cast<T>(x));
  }
};

// Four int8 cells in one word: bit 8b+7 is set where byte b > 0 (signed).
__device__ __forceinline__ unsigned bytes_positive(unsigned w) {
  return ((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) & ~w & 0x80808080u;
}

// Bit 8b+7 set where byte b equals v (0 <= v < 128): the exact zero-byte
// test of w ^ v repeated.
__device__ __forceinline__ unsigned bytes_equal(unsigned w, unsigned v) {
  const unsigned y = w ^ (v * 0x01010101u);
  return ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y) & 0x80808080u;
}

// Whether cell c of a lane's chunk is set in its byte-test word c / 4.
__device__ __forceinline__ bool cell_bit(unsigned m, int c) {
  return (m >> (8 * (c & 3) + 7)) & 1u;
}

}  // namespace kb
