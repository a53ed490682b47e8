// Shared pieces of the port's hand-written kernels: the block size of the
// deformable and lift-splat kernels, key widths, conversion to float, warp sums, 16-byte
// loads of bf16 or float rows and the C error helper.
//
// Every kernel has a float and a bfloat16 instantiation. The tile kernels
// (the FFN tail, the seg head) run on the tensor cores through wgmma
// (`hopper.cuh`): bfloat16 in one pass, float32 as TF32 in three passes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lss {

constexpr int kThreads = 256;  // the deformable and lift-splat kernels' blocks: 8 warps

// Bits that hold the values 0 .. v (at least 0 bits, for v = 0).
inline int bits_for(int v) {
  int bits = 0;
  while (bits < 31 && (v >> bits) != 0) ++bits;
  return bits;
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The lanes of this thread's group of 2^glog consecutive lanes within its
// warp, for the group's shuffles.
__device__ __forceinline__ unsigned group_mask(int glog) {
  if (glog == 5) return 0xffffffffu;
  const unsigned lanes = (1u << (1 << glog)) - 1u;
  return lanes << ((threadIdx.x & 31) & ~((1 << glog) - 1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint4 ld16(const char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes of T as floats, and back (bf16 rounded to nearest even).
template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

}  // namespace lss

// Each library exports its own copy, for the Python wrapper's error messages.
extern "C" const char* lss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
