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
//     1 << 21, clipped to uint8 (`clip8`), into a scratch (n, rows, fW
//     rounded up to 4) of one 32-bit word a pixel (R, G, B, 0);
//  2. per output pixel: the rotation's source pixel ((a2 + y a1 + x a0) >> 16,
//     zero outside), the flip, the vertical pass at that crop pixel (zero
//     outside the resized image), then x / 255, minus the mean, over the std,
//     each an IEEE float32 operation (`__fdiv_rn`, `__fsub_rn`: no reciprocal,
//     no contraction), as numpy computes them.
//
// What bounds it on the H100: at train-v2's 48 images of 900x1600 (resize
// 0.193-0.225, about 21 taps each way) the source windows the crops read and
// the float32 out come to about 172 MB (0.051 ms at 3.35 TB/s); the integer
// work is 3 multiply-adds a tap over about 300 M taps, most of them the
// horizontal pass's, on the FMA pipe, 64 lanes per SM per clock (the CUDA
// programming guide's rate for compute capability 9.0; 132 SMs, 1.98 GHz),
// and the clips and the rotation's coordinates besides.
// `ops/img_aug.py::bound` counts both from the batch's tables, the operations
// per tap and per pixel by pipe from the SASS of the `ops_probe_*` functions
// below.
//
// The design: every tap and weight is read from shared memory.
//  - Pass 1: a CTA takes 32 intermediate rows (one a lane) and at most 64
//    crop columns (fW cut evenly, in multiples of 4). It stages its
//    columns' weights and, with 4-byte `cp.async`, a warp a row, the source
//    bytes their windows span in its 32 rows (at most kSpanMax pixels at
//    once; wider spans in turns). A warp walks two columns at a time for its
//    32 rows: a column's window starts at the same byte in every lane's row,
//    rows lie an odd number of words apart (no bank conflict), and each lane
//    reads its window as 32-bit words, aligned with a funnel shift, 4 taps
//    (12 bytes, 3 words) per step beside one 16-byte broadcast read of their
//    weights. The words out go through shared memory to 16-byte stores.
//    (dp4a over per-channel planes with the weights in three 8-bit limbs,
//    also exact, took 0.236 ms against this pass's 0.203 ms at train-v2's
//    batch on an H100 80GB HBM3 at 700 W.)
//  - Pass 2: a CTA takes 32x32 output pixels. From the tile's corners it
//    finds the crop pixels its rotated, flipped footprint reads, stages their
//    vtab rows and the intermediate rows their windows span (16-byte
//    `cp.async`, kVCapWords at once, more in turns), and sums each pixel's
//    taps from there. The normalisation, a function of the channel's uint8
//    value alone, is a table of 3 x 256 floats made per CTA with the same
//    IEEE operations; the float32 planes are written coalesced.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kParams = 14;  // newW, newH, x0, y0, flip, rotate, a0..a5, row0, rows

constexpr int kHRows = 32;        // intermediate rows of a pass-1 CTA: one a lane
constexpr int kHCols = 64;        // crop columns of a pass-1 CTA at most
constexpr int kSpanMax = 448;     // source pixels a staged row holds
constexpr int kHPitch = 1380;     // a staged row: 3 * kSpanMax + 3 (alignment) + 28 (the last
                                  // steps' reads past a window), and an odd number of words
constexpr int kHOutPitch = kHCols + 4;  // words

constexpr int kVTile = 32;         // output pixels of a pass-2 CTA: kVTile x kVTile
constexpr int kVBoxRows = 48;      // crop rows a rotated tile reads at most: 31 (|cos| + |sin|) + 2
constexpr int kVCapWords = 12288;  // intermediate words staged at once

__device__ __forceinline__ int clip8(int acc) { return min(max(acc >> 22, 0), 255); }

__device__ __forceinline__ int byte_of(uint32_t w, int i) {
  return static_cast<int>(__byte_perm(w, 0, 0x4440 | i));
}

// ---- the arithmetic (shared by the kernel and the operation-count probes)

// One tap: a pixel's three channels times its weight.
__device__ __forceinline__ void tap(int (&s)[3], int r, int g, int b, int w) {
  s[0] += r * w;
  s[1] += g * w;
  s[2] += b * w;
}

// The crop pixel that output pixel (x, y) shows, through the rotation (a
// 16.16 fixed-point affine map, false outside the crop) and the flip.
__device__ __forceinline__ bool source_pixel(const int* p, int fh, int fw, int x, int y, int& xs,
                                             int& ys) {
  xs = x;
  ys = y;
  bool inside = true;
  if (p[5]) {
    const long long xx = (long long)p[8] + (long long)y * p[7] + (long long)x * p[6];
    const long long yy = (long long)p[11] + (long long)y * p[10] + (long long)x * p[9];
    xs = static_cast<int>(xx >> 16);
    ys = static_cast<int>(yy >> 16);
    inside = xx >= 0 && yy >= 0 && xs < fw && ys < fh;
  }
  if (p[4]) xs = fw - 1 - xs;
  return inside;
}

// ---- the kernels

using lss::cp_async16;
using lss::cp_async4;
using lss::cp_async_wait_all;

__host__ __device__ constexpr int h_smem_bytes(int kw) {
  return kHRows * kHPitch + kHRows * kHOutPitch * 4 + kHCols * kw * 4 + kHCols * 2 * 4 +
         kHCols * 4 * 4 + 4 * 4;
}
__host__ __device__ constexpr int v_smem_bytes(int kv) {
  return kVCapWords * 4 + kVBoxRows * kv * 4 + 3 * 256 * 4 + 4 * 4;
}

// Pass 1. kw: the weights' stride in shared memory (kh - 2 rounded up to 4).
__global__ void __launch_bounds__(kThreads) resize_h_kernel(
    const uint8_t* __restrict__ images, const int* __restrict__ params,
    const int* __restrict__ htab, uint32_t* __restrict__ inter, int n, int height, int width, int fw, int kh, int kw, int pw,
    int max_rows, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* src = smem;
  uint32_t* outs = reinterpret_cast<uint32_t*>(smem + kHRows * kHPitch);
  int* wt = reinterpret_cast<int*>(outs + kHRows * kHOutPitch);
  int* xmin = wt + kHCols * kw;
  int* cnt = xmin + kHCols;
  int* ranges = cnt + kHCols;  // (ja, jb, xa, xb) each
  int* misc = ranges + 4 * kHCols;
  const int img = blockIdx.z, r0 = blockIdx.y * kHRows, j0 = blockIdx.x * cols;
  const int* p = params + img * kParams;
  const int rows = p[13];
  if (r0 >= rows) return;
  const int nj = min(cols, fw - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    misc[0] = INT_MAX;
    misc[1] = INT_MIN;
  }
  const int* tab = htab + ((long long)img * fw + j0) * kh;
  for (int j = warp; j < nj; j += kThreads / 32)  // a warp a column: xmin, count, weights
    for (int k = lane; k < kw + 2; k += 32) {
      const int v = k < kh ? tab[j * kh + k] : 0;
      if (k == 0) xmin[j] = v;
      else if (k == 1) cnt[j] = v;
      else wt[j * kw + k - 2] = v;
    }
  __syncthreads();
  if (tid < nj && cnt[tid] > 0) {
    atomicMin(&misc[0], xmin[tid]);
    atomicMax(&misc[1], xmin[tid] + cnt[tid]);
  }
  __syncthreads();
  if (tid == 0) {  // the column ranges staged in turns: one unless the span is wide
    int nr = 0;
    if (misc[0] >= misc[1] || misc[1] - misc[0] <= kSpanMax) {  // no live column, or one turn
      ranges[0] = 0;
      ranges[1] = nj;
      ranges[2] = misc[0] < misc[1] ? misc[0] : 0;
      ranges[3] = misc[0] < misc[1] ? misc[1] : 0;
      nr = 1;
    } else {
      for (int ja = 0; ja < nj;) {
        int xa = INT_MAX, xb = INT_MIN, jb = ja;
        for (; jb < nj; ++jb) {
          if (cnt[jb] <= 0) continue;
          const int na = min(xa, xmin[jb]), nb = max(xb, xmin[jb] + cnt[jb]);
          if (nb - na > kSpanMax) break;
          xa = na;
          xb = nb;
        }
        if (xa > xb) xa = xb = 0;  // no live column
        ranges[4 * nr] = ja;
        ranges[4 * nr + 1] = jb;
        ranges[4 * nr + 2] = xa;
        ranges[4 * nr + 3] = xb;
        ++nr;
        ja = jb;
      }
    }
    misc[2] = nr;
  }
  __syncthreads();
  const uint8_t* end = images + (long long)n * height * width * 3;
  const int r = r0 + lane;
  const long long row_at = ((long long)img * height + p[12] + r) * width;
  for (int ri = 0; ri < misc[2]; ++ri) {
    const int ja = ranges[4 * ri], jb = ranges[4 * ri + 1];
    const int xa = ranges[4 * ri + 2], span = max(0, ranges[4 * ri + 3] - xa);
    if (ri) __syncthreads();  // the last range's taps are read
    for (int l = warp; span && l < kHRows && r0 + l < rows; l += kThreads / 32) {  // a warp a row
      const uint8_t* gs = images + (((long long)img * height + p[12] + r0 + l) * width + xa) * 3;
      const uint8_t* ga = reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(gs) & ~3ull);
      const int nw = static_cast<int>((gs + 3 * span - ga + 3) >> 2);
      for (int w = lane; w < nw; w += 32) {
        const uint8_t* g = ga + 4 * w;
        unsigned char* d = src + l * kHPitch + 4 * w;
        if (g + 4 <= end) {
          cp_async4(d, g);
        } else {  // the batch's last bytes: no read past its end
          for (int i = 0; g + i < end; ++i) d[i] = g[i];
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(images + (row_at + xa) * 3) & 3);
    // a warp two columns at a time, j and j + 8, for two independent sums
    for (int j = ja + warp; j < jb; j += 2 * (kThreads / 32)) {
      const int j2 = j + kThreads / 32 < jb ? j + kThreads / 32 : -1;
      const int c = cnt[j], c2 = j2 >= 0 ? cnt[j2] : 0;
      const bool live = c > 0 && r < rows, live2 = c2 > 0 && r < rows;
      int s[3] = {1 << 21, 1 << 21, 1 << 21}, s2[3] = {1 << 21, 1 << 21, 1 << 21};
      // a dead column reads from the span's start (its weights are all 0)
      const int a = lane * kHPitch + phase + 3 * ((live ? xmin[j] : xa) - xa);
      const int a2 = lane * kHPitch + phase + 3 * ((live2 ? xmin[j2] : xa) - xa);
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(src + (a & ~3));
      const uint32_t* wp2 = reinterpret_cast<const uint32_t*>(src + (a2 & ~3));
      const int sh = 8 * (a & 3), sh2 = 8 * (a2 & 3);
      const int4* wq = reinterpret_cast<const int4*>(wt + j * kw);
      const int4* wq2 = reinterpret_cast<const int4*>(wt + (j2 >= 0 ? j2 : j) * kw);
      // the longer window's steps for both: the shorter's weights past its
      // count are 0 (its reads stay inside shared memory)
      const int steps = (max(live ? c : 0, live2 ? c2 : 0) + 3) >> 2;
      uint32_t lo = wp[0], lo2 = wp2[0];
      for (int q = 0; q < steps; ++q) {
        const uint32_t w1 = wp[3 * q + 1], w2 = wp[3 * q + 2], w3 = wp[3 * q + 3];
        const uint32_t v1 = wp2[3 * q + 1], v2 = wp2[3 * q + 2], v3 = wp2[3 * q + 3];
        const uint32_t b0 = __funnelshift_r(lo, w1, sh), b1 = __funnelshift_r(w1, w2, sh),
                       b2 = __funnelshift_r(w2, w3, sh);
        const uint32_t e0 = __funnelshift_r(lo2, v1, sh2), e1 = __funnelshift_r(v1, v2, sh2),
                       e2 = __funnelshift_r(v2, v3, sh2);
        lo = w3;
        lo2 = v3;
        const int4 k = wq[q], k2 = wq2[q];
        tap(s, byte_of(b0, 0), byte_of(b0, 1), byte_of(b0, 2), k.x);
        tap(s2, byte_of(e0, 0), byte_of(e0, 1), byte_of(e0, 2), k2.x);
        tap(s, byte_of(b0, 3), byte_of(b1, 0), byte_of(b1, 1), k.y);
        tap(s2, byte_of(e0, 3), byte_of(e1, 0), byte_of(e1, 1), k2.y);
        tap(s, byte_of(b1, 2), byte_of(b1, 3), byte_of(b2, 0), k.z);
        tap(s2, byte_of(e1, 2), byte_of(e1, 3), byte_of(e2, 0), k2.z);
        tap(s, byte_of(b2, 1), byte_of(b2, 2), byte_of(b2, 3), k.w);
        tap(s2, byte_of(e2, 1), byte_of(e2, 2), byte_of(e2, 3), k2.w);
      }
      outs[lane * kHOutPitch + j] = live ? clip8(s[0]) | clip8(s[1]) << 8 | clip8(s[2]) << 16 : 0;
      if (j2 >= 0)
        outs[lane * kHOutPitch + j2] =
            live2 ? clip8(s2[0]) | clip8(s2[1]) << 8 | clip8(s2[2]) << 16 : 0;
    }
  }
  __syncthreads();
  const int nq = (nj + 3) >> 2;
  for (int l = warp; l < kHRows && r0 + l < rows; l += kThreads / 32)  // a warp a row
    for (int q = lane; q < nq; q += 32) {
      const uint32_t* o = outs + l * kHOutPitch + 4 * q;
      const int j = 4 * q;
      const uint4 v = make_uint4(o[0], j + 1 < nj ? o[1] : 0u, j + 2 < nj ? o[2] : 0u,
                                 j + 3 < nj ? o[3] : 0u);
      *reinterpret_cast<uint4*>(inter + ((long long)img * max_rows + r0 + l) * pw + j0 + j) = v;
    }
}

// Pass 2.
__global__ void __launch_bounds__(kThreads) resize_v_kernel(
    const uint32_t* __restrict__ inter, const int* __restrict__ params,
    const int* __restrict__ vtab, float* __restrict__ out, int fh, int fw, int kv, int pw,
    int max_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
  float* norm = reinterpret_cast<float*>(stage + kVCapWords);  // [3][256]: a channel's value out
  int* vt = reinterpret_cast<int*>(norm + 3 * 256);
  int* misc = vt + kVBoxRows * kv;
  const int img = blockIdx.y, tid = threadIdx.x;
  {
    const float mean[3] = {0.485f, 0.456f, 0.406f};
    const float std[3] = {0.229f, 0.224f, 0.225f};
    for (int i = tid; i < 3 * 256; i += kThreads) {
      const int c = i >> 8;
      norm[i] = __fdiv_rn(__fsub_rn(__fdiv_rn(static_cast<float>(i & 255), 255.0f), mean[c]),
                          std[c]);
    }
  }
  const int tiles_x = (fw + kVTile - 1) / kVTile;
  const int ty0 = (blockIdx.x / tiles_x) * kVTile, tx0 = (blockIdx.x % tiles_x) * kVTile;
  const int* p = params + img * kParams;
  // the crop pixels the tile's footprint reads: from its corners
  const int tx1 = min(tx0 + kVTile, fw) - 1, ty1 = min(ty0 + kVTile, fh) - 1;
  int bx0 = tx0, bx1 = tx1, by0 = ty0, by1 = ty1;
  if (p[5]) {
    bx0 = by0 = INT_MAX;
    bx1 = by1 = INT_MIN;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int x = c & 1 ? tx1 : tx0, y = c & 2 ? ty1 : ty0;
      const long long xx = (long long)p[8] + (long long)y * p[7] + (long long)x * p[6];
      const long long yy = (long long)p[11] + (long long)y * p[10] + (long long)x * p[9];
      const int xs = static_cast<int>(xx >> 16), ys = static_cast<int>(yy >> 16);
      bx0 = min(bx0, xs);
      bx1 = max(bx1, xs);
      by0 = min(by0, ys);
      by1 = max(by1, ys);
    }
  }
  if (p[4]) {
    const int f0 = fw - 1 - bx1;
    bx1 = fw - 1 - bx0;
    bx0 = f0;
  }
  bx0 = max(bx0, 0);
  bx1 = min(bx1, fw - 1);
  by0 = max(by0, 0);
  by1 = min(by1, fh - 1);
  const bool any = p[13] > 0 && bx0 <= bx1 && by0 <= by1;
  if (tid == 0) {
    misc[0] = INT_MAX;
    misc[1] = INT_MIN;
  }
  if (any)
    for (int e = tid; e < (by1 - by0 + 1) * kv; e += kThreads)
      vt[e] = vtab[((long long)img * fh + by0) * kv + e];
  __syncthreads();
  if (any && tid <= by1 - by0 && vt[tid * kv + 1] > 0) {
    atomicMin(&misc[0], vt[tid * kv]);
    atomicMax(&misc[1], vt[tid * kv] + vt[tid * kv + 1]);
  }
  __syncthreads();
  const int R0 = misc[0], R1 = misc[1];
  // this thread's pixels: one column, every 8th row of the tile
  constexpr int kPix = kVTile * kVTile / kThreads;
  const int x = tx0 + (tid & 31);
  int xc[kPix], yc[kPix], first[kPix], count[kPix], s[kPix][3];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int y = ty0 + (tid >> 5) + (kThreads / 32) * i;
    count[i] = first[i] = xc[i] = yc[i] = 0;
    s[i][0] = s[i][1] = s[i][2] = 1 << 21;
    if (!any || x >= fw || y >= fh) continue;
    if (!source_pixel(p, fh, fw, x, y, xc[i], yc[i])) continue;
    first[i] = vt[(yc[i] - by0) * kv];
    count[i] = vt[(yc[i] - by0) * kv + 1];
  }
  const int bxa = bx0 & ~3, bw = ((bx1 | 3) + 1) - bxa;
  const int rc = kVCapWords / max(bw, 1);
  for (int ra = R0; any && ra < R1; ra += rc) {
    const int rb = min(R1, ra + rc);
    if (ra > R0) __syncthreads();  // the last chunk's taps are read
    for (int rr = tid >> 5; rr < rb - ra; rr += kThreads / 32) {  // a warp a row
      const uint32_t* g = inter + ((long long)img * max_rows + ra + rr) * pw + bxa;
      for (int q = 4 * (tid & 31); q < bw; q += 128) cp_async16(stage + rr * bw + q, g + q);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      if (!count[i]) continue;
      const int k0 = max(0, ra - first[i]), k1 = min(count[i], rb - first[i]);
      const uint32_t* col = stage + (first[i] + k0 - ra) * bw + (xc[i] - bxa);
      const int* w = vt + (yc[i] - by0) * kv + 2;
      for (int k = k0; k < k1; ++k, col += bw) {
        const uint32_t v = *col;
        tap(s[i], byte_of(v, 0), byte_of(v, 1), byte_of(v, 2), w[k]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int y = ty0 + (tid >> 5) + (kThreads / 32) * i;
    if (x >= fw || y >= fh) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[(((long long)img * 3 + c) * fh + y) * fw + x] =
          norm[256 * c + (count[i] ? clip8(s[i][c]) : 0)];
  }
}

}  // namespace

extern "C" int img_aug_forward(const void* images, const void* params, const void* htab,
                               const void* vtab, void* scratch, void* out, int n, int height,
                               int width, int fh, int fw, int kh, int kv, int max_rows,
                               void* stream) {
  if (n <= 0 || n > 65535 || kh < 3 || kh - 2 > kSpanMax || kv < 3 || max_rows < 0 ||
      (max_rows + kHRows - 1) / kHRows > 65535 || fh <= 0 || fw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kw = ((kh - 2) + 3) & ~3, pw = (fw + 3) & ~3;
  if (max_rows > 0) {
    const int bytes = h_smem_bytes(kw);
    cudaError_t err =
        cudaFuncSetAttribute(resize_h_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    // fW cut evenly into pieces of at most kHCols, multiples of 4 (16-byte stores)
    const int pieces = (fw + kHCols - 1) / kHCols;
    const int cols = ((fw + pieces - 1) / pieces + 3) & ~3;
    resize_h_kernel<<<dim3((fw + cols - 1) / cols, (max_rows + kHRows - 1) / kHRows, n), kThreads,
                      bytes, s>>>(
        static_cast<const uint8_t*>(images), static_cast<const int*>(params),
        static_cast<const int*>(htab), static_cast<uint32_t*>(scratch), n, height, width, fw, kh,
        kw, pw, max_rows, cols);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int bytes = v_smem_bytes(kv);
  cudaError_t err =
      cudaFuncSetAttribute(resize_v_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((fw + kVTile - 1) / kVTile) * ((fh + kVTile - 1) / kVTile);
  resize_v_kernel<<<dim3(tiles, n), kThreads, bytes, s>>>(
      static_cast<const uint32_t*>(scratch), static_cast<const int*>(params),
      static_cast<const int*>(vtab), static_cast<float*>(out), fh, fw, kv, pw, max_rows);
  return static_cast<int>(cudaGetLastError());
}

// ---- the probes: the arithmetic alone, on values in registers, never
// launched (outside the anonymous namespace, so that they are compiled);
// `ops/_build.py::sass_int_ops` counts their integer instructions in the
// built library for `ops/img_aug.py::bound`.

// A tap of either pass: a pixel's three channels times its weight.
extern "C" __global__ void ops_probe_tap(const int* __restrict__ in, int* __restrict__ out) {
  int s[3] = {in[0], in[1], in[2]};
  tap(s, in[3], in[4], in[5], in[6]);
  out[0] = s[0];
  out[1] = s[1];
  out[2] = s[2];
}

// A pixel of either pass: its three sums clipped.
extern "C" __global__ void ops_probe_clip(const int* __restrict__ in, int* __restrict__ out) {
  out[0] = clip8(in[0]);
  out[1] = clip8(in[1]);
  out[2] = clip8(in[2]);
}

// An output pixel's source pixel through the rotation and the flip.
extern "C" __global__ void ops_probe_source(const int* __restrict__ in, int* __restrict__ out) {
  int xs, ys;
  out[2] = source_pixel(in, in[14], in[15], in[16], in[17], xs, ys);
  out[0] = xs;
  out[1] = ys;
}
