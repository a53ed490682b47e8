// Shared pieces of the port's hand-written kernels: dtype conversion, warp
// sums, a 256-thread float tile product and the C error helper.
//
// Every kernel has a float and a bfloat16 instantiation. The tile product
// `TileMMA<M, N>` of the float tile kernels accumulates an M x N float tile
// from row-major operands in shared memory with plain FMA on the SIMT cores,
// so the float paths keep full float32 precision (no TF32 rounding). The
// bfloat16 tile kernels run on the tensor cores through wgmma (`hopper.cuh`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lss {

constexpr int kThreads = 256;  // every tile kernel runs 8 warps

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Each thread owns an (M/16) x (N/16) register block; thread (ty, tx) holds
// rows ty*RM + i and columns tx + 16*j.
template <int M, int N> struct TileMMA {
  static constexpr int RM = M / 16, RN = N / 16;
  float acc[RM][RN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  }

  // acc += A[M x K] @ B[K x N]
  __device__ __forceinline__ void mma(const float* A, int lda, const float* B, int ldb, int K) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    for (int k = 0; k < K; ++k) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = A[(ty * RM + i) * lda + k];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) C[(ty * RM + i) * ldc + tx + 16 * j] = acc[i][j];
  }

  __device__ __forceinline__ void load(const float* C, int ldc) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = C[(ty * RM + i) * ldc + tx + 16 * j];
  }
};

// Bytes of `count` elements of T rounded up to 128, so consecutive
// shared-memory regions stay aligned.
template <typename T> __host__ __device__ constexpr size_t region(size_t count) {
  return (count * sizeof(T) + 127) / 128 * 128;
}

}  // namespace lss

// Each library exports its own copy, for the Python wrapper's error messages.
extern "C" const char* lss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
