// Shared pieces of the port's hand-written kernels: the block size of the
// deformable kernels, conversion to float, warp sums and the C error helper.
//
// Every kernel has a float and a bfloat16 instantiation. The tile kernels
// (the FFN tail, the seg head) run on the tensor cores through wgmma
// (`hopper.cuh`): bfloat16 in one pass, float32 as TF32 in three passes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lss {

constexpr int kThreads = 256;  // the deformable kernels' blocks: 8 warps

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace lss

// Each library exports its own copy, for the Python wrapper's error messages.
extern "C" const char* lss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
