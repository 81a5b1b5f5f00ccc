// Shared pieces of the row-reduction kernels: block reductions, 16-byte
// row loads, and the error string of a launch's return code.
//
// The fingerprint and suspicion kernels reduce one row of an [N, N] plane
// per block: the threads stride over the row (16 columns per thread per
// step when the rows are 16-byte aligned, one column otherwise), reduce in
// registers, then across the warp with shuffles and across the warps
// through shared memory. The oldest-k kernel gives each row one warp (its
// head comment says why).
#pragma once

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#define KB_THREADS 256

extern "C" const char* kb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct MinOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return b < a ? b : a; }
};
struct MaxOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return b > a ? b : a; }
};

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Reduce one value per thread over the block; the result is valid in
// thread 0. Ends with a barrier so the scratch can be reused at once.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T identity) {
  __shared__ T scratch[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_reduce(v, op);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? scratch[lane] : identity;
    v = warp_reduce(v, op);
  }
  __syncthreads();
  return v;
}

// 16 consecutive elements from a 16-byte aligned address, as int4 words.
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p, T (&out)[16]) {
  constexpr int kWords = 16 * sizeof(T) / 16;
  const int4* src = reinterpret_cast<const int4*>(p);
  int4* dst = reinterpret_cast<int4*>(out);
#pragma unroll
  for (int w = 0; w < kWords; ++w) dst[w] = __ldg(src + w);
}

// The (timer, column) pair as one key whose signed order is the
// lexicographic order: timer first, then the column.
__device__ __forceinline__ long long lex_key(int t, int j) {
  return static_cast<long long>(t) * 4294967296LL + j;
}
