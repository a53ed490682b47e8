// Kernel 6: JPEG decoding after the entropy decoding, for a whole batch of
// images. Dequantise, IDCT, upsample, convert colour, as libjpeg-turbo does
// with PIL's settings, bit for bit, into uint8 RGB (n, H, W, 3).
//
// No TPU kernel stands behind it: the JAX package decodes with PIL on the
// host (`data/dataset.py:87-98` there). The host entropy-decodes
// (`jpeg_entropy.cu`); this kernel takes the quantised coefficients. Its plain
// version is `ops/jpeg_idct.py::decode_plain`, the same integer arithmetic in
// PyTorch calls.
//
// Two launches:
//  1. one thread per 8x8 block: the block's 64 coefficients times its table,
//     libjpeg's `jpeg_idct_islow` (13-bit constants, pass 1 over columns
//     keeping 2 extra bits, pass 2 over rows descaling by 18), its range-limit
//     table, 64 samples written in place of the block in a uint8 scratch;
//  2. one thread per pixel: the luma sample, the chroma upsampled by
//     `h2v2_fancy_upsample` (column sums 3 near + 1 far row, then 3:1 across
//     with +8 / +7 rounding, edges replicated; plain replication where the
//     chroma is at most 2 wide) for 4:2:0, and `ycc_rgb_convert`'s
//     fixed-point tables.
// 32-bit integers throughout, as libjpeg-turbo's SIMD code uses.
//
// What bounds it on the H100: bytes. The batch reads 128 bytes of
// coefficients per block and writes 3 bytes per pixel (4:2:0: 1.5 blocks per
// 64 pixels, so 3 bytes in per 3 out); the scratch of samples (1 byte per
// coefficient) stays in L2 at a batch of 48 images of 900x1600 only in part.
// This first version makes no use of shared memory: each thread of launch 1
// reads its block with 16-byte loads (a warp spans 32 blocks, 4 KB), and
// launch 2 reads up to 5 samples per pixel through L1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// One pass of jpeg_idct_islow over v[0..7] (stride `step` in `v`): outputs
// descaled by `shift` (11 after columns, 18 after rows).
__device__ __forceinline__ void idct_1d(const int* in, int step, int shift, int* out) {
  int z2 = in[2 * step], z3 = in[6 * step];
  int z1 = (z2 + z3) * 4433;
  const int tmp2 = z1 + z3 * -15137;
  const int tmp3 = z1 + z2 * 6270;
  const int tmp0e = (in[0] + in[4 * step]) * 8192;
  const int tmp1e = (in[0] - in[4 * step]) * 8192;
  const int tmp10 = tmp0e + tmp3, tmp13 = tmp0e - tmp3;
  const int tmp11 = tmp1e + tmp2, tmp12 = tmp1e - tmp2;
  int t0 = in[7 * step], t1 = in[5 * step], t2 = in[3 * step], t3 = in[1 * step];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int z4 = t1 + t3;
  const int z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int rnd = 1 << (shift - 1);
  out[0] = (tmp10 + t3 + rnd) >> shift;
  out[7] = (tmp10 - t3 + rnd) >> shift;
  out[1] = (tmp11 + t2 + rnd) >> shift;
  out[6] = (tmp11 - t2 + rnd) >> shift;
  out[2] = (tmp12 + t1 + rnd) >> shift;
  out[5] = (tmp12 - t1 + rnd) >> shift;
  out[3] = (tmp13 + t0 + rnd) >> shift;
  out[4] = (tmp13 - t0 + rnd) >> shift;
}

// libjpeg's post-IDCT range limit, indexed by (value & 1023).
__device__ __forceinline__ int range_limit(int v) {
  v &= 1023;
  return v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896;
}

struct Image {
  long long first;  // first block of the image in the batch
  int ncomp, hs, vs;
  int across0, n0;  // luma blocks across and in all
  int across1, n1;  // each chroma component's
  __device__ __forceinline__ Image(const int* meta, int img, int height, int width) {
    first = meta[4 * img];
    ncomp = meta[4 * img + 1];
    hs = meta[4 * img + 2];
    vs = meta[4 * img + 3];
    const int mx = (width + 8 * hs - 1) / (8 * hs), my = (height + 8 * vs - 1) / (8 * vs);
    across0 = mx * hs;
    n0 = across0 * my * vs;
    across1 = mx;
    n1 = mx * my;
  }
  // sample (row, col) of component c
  __device__ __forceinline__ int sample(const uint8_t* samples, int c, int row, int col) const {
    const long long blk = first + (c == 0 ? 0 : n0 + (long long)(c - 1) * n1) +
                          (long long)(row >> 3) * (c == 0 ? across0 : across1) + (col >> 3);
    return samples[blk * 64 + (row & 7) * 8 + (col & 7)];
  }
};

__global__ void idct_kernel(const int16_t* __restrict__ coefs, const int* __restrict__ quant,
                            const int* __restrict__ meta, uint8_t* __restrict__ samples,
                            int height, int width) {
  const int img = blockIdx.y;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const Image im(meta, img, height, width);
  if (b >= im.n0 + (im.ncomp - 1) * im.n1) return;
  const int c = b < im.n0 ? 0 : 1 + (b - im.n0) / im.n1;
  const int* q = quant + (img * 3 + c) * 64;
  const long long blk = im.first + b;
  int x[64];
  const int4* src = reinterpret_cast<const int4*>(coefs + blk * 64);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int4 v = src[i];
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lo = static_cast<int16_t>(w[j] & 0xffff), hi = w[j] >> 16;
      x[8 * i + 2 * j] = lo * q[8 * i + 2 * j];
      x[8 * i + 2 * j + 1] = hi * q[8 * i + 2 * j + 1];
    }
  }
  int ws[64];
  int col[8];
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8) {  // pass 1: columns
    idct_1d(x + c8, 8, 11, col);
#pragma unroll
    for (int k = 0; k < 8; ++k) ws[8 * k + c8] = col[k];
  }
  uint32_t packed[16];
#pragma unroll
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    int row[8];
    idct_1d(ws + 8 * r, 1, 18, row);
    packed[2 * r] = range_limit(row[0]) | range_limit(row[1]) << 8 | range_limit(row[2]) << 16 |
                    range_limit(row[3]) << 24;
    packed[2 * r + 1] = range_limit(row[4]) | range_limit(row[5]) << 8 |
                        range_limit(row[6]) << 16 | range_limit(row[7]) << 24;
  }
  uint4* dst = reinterpret_cast<uint4*>(samples + blk * 64);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = make_uint4(packed[4 * i], packed[4 * i + 1], packed[4 * i + 2], packed[4 * i + 3]);
}

__device__ __forceinline__ int clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

__global__ void color_kernel(const uint8_t* __restrict__ samples, const int* __restrict__ meta,
                             uint8_t* __restrict__ out, int height, int width) {
  const int img = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= height * width) return;
  const int y = pix / width, x = pix - y * width;
  const Image im(meta, img, height, width);
  uint8_t* o = out + ((long long)img * height * width + pix) * 3;
  const int luma = im.sample(samples, 0, y, x);
  if (im.ncomp == 1) {
    o[0] = o[1] = o[2] = static_cast<uint8_t>(luma);
    return;
  }
  int chroma[2];
  if (im.hs == 1) {
    chroma[0] = im.sample(samples, 1, y, x);
    chroma[1] = im.sample(samples, 2, y, x);
  } else {
    const int dsh = (height + 1) >> 1, dsw = (width + 1) >> 1;
    const int iy = y >> 1, ix = x >> 1;
    if (dsw > 2) {
      const int far = (y & 1) ? min(iy + 1, dsh - 1) : max(iy - 1, 0);
      const int jx = (x & 1) ? min(ix + 1, dsw - 1) : max(ix - 1, 0);
      const int rnd = (x & 1) ? 7 : 8;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int here = 3 * im.sample(samples, c + 1, iy, ix) + im.sample(samples, c + 1, far, ix);
        const int next = 3 * im.sample(samples, c + 1, iy, jx) + im.sample(samples, c + 1, far, jx);
        chroma[c] = (3 * here + next + rnd) >> 4;
      }
    } else {
      chroma[0] = im.sample(samples, 1, iy, ix);
      chroma[1] = im.sample(samples, 2, iy, ix);
    }
  }
  const int cb = chroma[0] - 128, cr = chroma[1] - 128;
  o[0] = static_cast<uint8_t>(clamp255(luma + ((91881 * cr + 32768) >> 16)));
  o[1] = static_cast<uint8_t>(clamp255(luma + ((-22554 * cb + 32768 - 46802 * cr) >> 16)));
  o[2] = static_cast<uint8_t>(clamp255(luma + ((116130 * cb + 32768) >> 16)));
}

}  // namespace

extern "C" int jpeg_idct_decode(const void* coefs, const void* quant, const void* meta,
                                void* samples, void* out, int n, int height, int width,
                                int max_blocks, void* stream) {
  if (n <= 0 || n > 65535 || max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  idct_kernel<<<dim3((max_blocks + 127) / 128, n), 128, 0, s>>>(
      static_cast<const int16_t*>(coefs), static_cast<const int*>(quant),
      static_cast<const int*>(meta), static_cast<uint8_t*>(samples), height, width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pixels = (long long)height * width;
  color_kernel<<<dim3(static_cast<unsigned>((pixels + 255) / 256), n), 256, 0, s>>>(
      static_cast<const uint8_t*>(samples), static_cast<const int*>(meta),
      static_cast<uint8_t*>(out), height, width);
  return static_cast<int>(cudaGetLastError());
}
