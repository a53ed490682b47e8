// Kernel 7: the camera images' augmentation, PIL-exact: Pillow's
// resize (BICUBIC, antialiased) -> crop -> FLIP_LEFT_RIGHT -> rotate
// (NEAREST), then ToTensor + Normalize in float32, into (n, 3, fH, fW).
//
// No TPU kernel stands behind it: the JAX package resamples with PIL on the
// host (`data/dataset.py::img_transform` and `normalize_img` there). Its plain
// version is `ops/img_aug.py::augment_plain`; `ops/img_aug.py::plan` computes
// on the host what both read: Pillow's weights in 22-bit fixed point per crop
// column (htab) and crop row (vtab), each (first source sample, count,
// weights...), and per image (params) the resized size, the crop's corner,
// the flip, the rotation in Pillow's 16.16 fixed point and the source rows
// the vertical pass reads.
//
// Two launches, as Pillow runs two passes with a uint8 image between them:
//  1. the horizontal pass over the source rows the vertical pass reads and
//     the crop's columns only: per (image, row, column) the weighted sum from
//     1 << 21, clipped to uint8 (`clip8`), into a scratch (n, rows, fW, 3);
//  2. per output pixel: the rotation's source pixel ((a2 + y a1 + x a0) >> 16,
//     zero outside), the flip, the vertical pass at that crop pixel (zero
//     outside the resized image), then x / 255, minus the mean, over the std,
//     each an IEEE float32 operation (`__fdiv_rn`, `__fsub_rn`: no reciprocal,
//     no contraction), as numpy computes them.
//
// What bounds it on the H100: bytes. Launch 1 reads the source rows' windows
// (about 5 source pixels per output pixel at 900x1600 -> 352 wide) and launch 2
// writes 12 bytes of float per pixel. This first version reads its windows
// straight from global memory through L1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kParams = 14;  // newW, newH, x0, y0, flip, rotate, a0..a5, row0, rows

__device__ __forceinline__ uint8_t clip8(int acc) {
  if (acc >= (1 << 30)) return 255;
  if (acc <= 0) return 0;
  return static_cast<uint8_t>(acc >> 22);
}

__global__ void resize_h_kernel(const uint8_t* __restrict__ images, const int* __restrict__ params,
                                const int* __restrict__ htab, uint8_t* __restrict__ scratch,
                                int height, int width, int fw, int kh, int max_rows) {
  const int img = blockIdx.z, r = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int* p = params + img * kParams;
  if (r >= p[13] || j >= fw) return;
  const int* t = htab + ((long long)img * fw + j) * kh;
  const int xmin = t[0], count = t[1];
  const uint8_t* src = images + (((long long)img * height + p[12] + r) * width + xmin) * 3;
  int s0 = 1 << 21, s1 = 1 << 21, s2 = 1 << 21;
  for (int k = 0; k < count; ++k) {
    const int w = t[2 + k];
    s0 += src[3 * k] * w;
    s1 += src[3 * k + 1] * w;
    s2 += src[3 * k + 2] * w;
  }
  uint8_t* o = scratch + (((long long)img * max_rows + r) * fw + j) * 3;
  o[0] = count ? clip8(s0) : 0;
  o[1] = count ? clip8(s1) : 0;
  o[2] = count ? clip8(s2) : 0;
}

__global__ void resize_v_kernel(const uint8_t* __restrict__ scratch, const int* __restrict__ params,
                                const int* __restrict__ vtab, float* __restrict__ out, int fh,
                                int fw, int kv, int max_rows) {
  const int img = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= fh * fw) return;
  const int y = pix / fw, x = pix - y * fw;
  const int* p = params + img * kParams;
  int xs = x, ys = y;
  bool inside = true;
  if (p[5]) {
    const long long xx = (long long)p[8] + (long long)y * p[7] + (long long)x * p[6];
    const long long yy = (long long)p[11] + (long long)y * p[10] + (long long)x * p[9];
    xs = static_cast<int>(xx >> 16);
    ys = static_cast<int>(yy >> 16);
    inside = xx >= 0 && yy >= 0 && xs < fw && ys < fh;
  }
  if (p[4]) xs = fw - 1 - xs;
  int v[3] = {0, 0, 0};
  if (inside) {
    const int* t = vtab + ((long long)img * fh + ys) * kv;
    const int first = t[0], count = t[1];
    if (count) {
      int s[3] = {1 << 21, 1 << 21, 1 << 21};
      for (int k = 0; k < count; ++k) {
        const uint8_t* src = scratch + (((long long)img * max_rows + first + k) * fw + xs) * 3;
        const int w = t[2 + k];
        s[0] += src[0] * w;
        s[1] += src[1] * w;
        s[2] += src[2] * w;
      }
      v[0] = clip8(s[0]);
      v[1] = clip8(s[1]);
      v[2] = clip8(s[2]);
    }
  }
  const float mean[3] = {0.485f, 0.456f, 0.406f};
  const float std[3] = {0.229f, 0.224f, 0.225f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f = __fdiv_rn(static_cast<float>(v[c]), 255.0f);
    out[(((long long)img * 3 + c) * fh + y) * fw + x] = __fdiv_rn(__fsub_rn(f, mean[c]), std[c]);
  }
}

}  // namespace

extern "C" int img_aug_forward(const void* images, const void* params, const void* htab,
                               const void* vtab, void* scratch, void* out, int n, int height,
                               int width, int fh, int fw, int kh, int kv, int max_rows,
                               void* stream) {
  if (n <= 0 || n > 65535 || max_rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_rows > 0) {
    resize_h_kernel<<<dim3((fw + 127) / 128, max_rows, n), 128, 0, s>>>(
        static_cast<const uint8_t*>(images), static_cast<const int*>(params),
        static_cast<const int*>(htab), static_cast<uint8_t*>(scratch), height, width, fw, kh,
        max_rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  resize_v_kernel<<<dim3((fh * fw + 255) / 256, n), 256, 0, s>>>(
      static_cast<const uint8_t*>(scratch), static_cast<const int*>(params),
      static_cast<const int*>(vtab), static_cast<float*>(out), fh, fw, kv, max_rows);
  return static_cast<int>(cudaGetLastError());
}
