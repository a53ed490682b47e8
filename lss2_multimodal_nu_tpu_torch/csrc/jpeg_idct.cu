// Kernel 6: JPEG decoding after the entropy decoding, for a whole batch of
// images. Dequantise, IDCT, upsample, convert colour, as libjpeg-turbo does
// with PIL's settings, bit for bit, into uint8 RGB (n, H, W, 3).
//
// No TPU kernel stands behind it: the JAX package decodes with PIL on the
// host (`data/dataset.py:87-98` there). The host entropy-decodes
// (`jpeg_entropy.cu`); this kernel takes the quantised coefficients. Its plain
// version is `ops/jpeg_idct.py::decode_plain`, the same integer arithmetic in
// PyTorch calls. The arithmetic: libjpeg's `jpeg_idct_islow` (13-bit
// constants, pass 1 over columns keeping 2 extra bits, pass 2 over rows
// descaling by 18, its range-limit table), `h2v2_fancy_upsample` for 4:2:0
// (column sums 3 near + 1 far row, then 3:1 across with +8 / +7 rounding,
// edges replicated; plain replication where the chroma is at most 2 wide)
// and `ycc_rgb_convert`'s fixed-point tables, in 32-bit integers.
//
// What bounds it on the H100: bytes and integer operations, close together.
// A batch of 48 4:2:0 images of 900x1600 reads 210 MB of int16 coefficients
// and writes 207 MB of RGB (0.125 ms at 3.35 TB/s), and runs about 1,000
// integer operations a block and 21 a pixel, 3.1 G in all (counted from the
// SASS of the `ops_probe_*` functions below, which run the same arithmetic on
// values in registers). Multiplies issue to the FMA pipe, adds, shifts, logic,
// min/max and compares to the ALU pipe, each 64 lanes per SM per clock, and an
// SM issues 128 lanes' worth a clock at most (the CUDA programming guide's
// rates for compute capability 9.0; 132 SMs, 1.98 GHz): the busier pipe, or
// the sum at the issue rate, sets the operations' time. `ops/jpeg_idct.py::
// bound` counts both for a batch. No tensor core is used: every step must
// equal libjpeg's 32-bit integer arithmetic bit for bit, and an exact product
// on the tensor cores would split the 13-bit constants and the 16-bit
// coefficients into 8-bit limbs (several int8 products and their carries per
// pass), which is untried (ROADMAP.md).
//
// The design: one launch. A CTA owns a rectangle of one image: a strip of at
// most kStripMax pixels across (whole MCUs) and a band of MCU rows, which it
// walks down one MCU row a step, so nothing it decodes leaves the chip (the
// entry point cuts the bands for about 12 CTAs an SM, 3 of them resident,
// which balances the SMs better than fewer, longer walks that decode less of
// the chroma halo twice):
//  - each step's coefficients (the MCU row's luma blocks; with 4:2:0 the
//    next chroma block row, one block wider on each side for the upsampling's
//    halo) lie in 4 contiguous runs of the packed layout, copied into shared
//    memory with 16-byte `cp.async`, the next step's copy running under this
//    step's colour conversion;
//  - eight threads take a block: each dequantises and transforms one column,
//    the columns go through shared memory, each transforms one row and
//    writes its 8 samples to the step's sample planes in shared memory;
//  - the chroma planes are a ring of 3 block rows, so the rows above and below
//    an MCU row (the upsampling's vertical halo) are at hand when it is
//    converted; a band starts with the chroma block row above it;
//  - threads convert 2x4 pixels each (4:2:0; 1x4 otherwise) into a staging
//    row of RGB in shared memory, written out with 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStripMax = 320;   // pixels across a strip at most (multiple of 16)
constexpr int kCtasPerSm = 12;   // CTAs the bands aim at on each SM (3 resident, in 4 waves)
constexpr int kSlotBytes = 144;  // a block's 128 bytes of coefficients, + 16 so that the
                                 // four blocks of a warp's column reads fall in distinct banks
constexpr int kMaxSlots = 3 * kStripMax / 8 + 4;  // blocks a step decodes at most (4:2:0)
constexpr int kWsWords = 104;   // a group's 8x8 int32 workspace: rows 12 words apart, and 104
                                // words apart so a warp's four groups hit distinct banks
constexpr int kLumaPitch = kStripMax + 8;
constexpr int kChromaPitch = kStripMax / 2 + 16 + 8;  // a strip's chroma and its halo blocks
constexpr int kRingBytes = 8 * kChromaPitch;          // one chroma block row of one component
constexpr int kChromaBytes =
    3 * kRingBytes > 8 * kLumaPitch ? 3 * kRingBytes : 8 * kLumaPitch;  // 4:2:0 ring, or 4:4:4
constexpr int kStagePitch = 3 * kStripMax + 16;

constexpr int kCoefOffset = 0;
constexpr int kWsOffset = kCoefOffset + kMaxSlots * kSlotBytes;
constexpr int kQuantOffset = kWsOffset + (kThreads / 8) * kWsWords * 4;
constexpr int kLumaOffset = kQuantOffset + 3 * 64 * 4;
constexpr int kChromaOffset = kLumaOffset + 16 * kLumaPitch;
constexpr int kStageOffset = kChromaOffset + 2 * kChromaBytes;
constexpr int kSmemBytes = kStageOffset + 16 * kStagePitch;

// ---- the arithmetic (shared by the kernel and the operation-count probes)

// One pass of jpeg_idct_islow over v[0..7] in place, descaled by `shift` with
// rounding (11 after the columns, 18 after the rows).
__device__ __forceinline__ void idct_1d(int (&v)[8], int shift) {
  int z2 = v[2], z3 = v[6];
  int z1 = (z2 + z3) * 4433;
  const int tmp2 = z1 + z3 * -15137;
  const int tmp3 = z1 + z2 * 6270;
  const int rnd = 1 << (shift - 1);
  const int tmp0e = (v[0] + v[4]) * 8192 + rnd;
  const int tmp1e = (v[0] - v[4]) * 8192 + rnd;
  const int tmp10 = tmp0e + tmp3, tmp13 = tmp0e - tmp3;
  const int tmp11 = tmp1e + tmp2, tmp12 = tmp1e - tmp2;
  int t0 = v[7], t1 = v[5], t2 = v[3], t3 = v[1];
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
  v[0] = (tmp10 + t3) >> shift;
  v[7] = (tmp10 - t3) >> shift;
  v[1] = (tmp11 + t2) >> shift;
  v[6] = (tmp11 - t2) >> shift;
  v[2] = (tmp12 + t1) >> shift;
  v[5] = (tmp12 - t1) >> shift;
  v[3] = (tmp13 + t0) >> shift;
  v[4] = (tmp13 - t0) >> shift;
}

// libjpeg's post-IDCT range limit: its table indexed by (v & 1023) is
// 128 + the 10-bit two's complement value of v, clamped to 0..255.
__device__ __forceinline__ int range_limit(int v) {
  const int s = ((v << 22) >> 22) + 128;
  return min(max(s, 0), 255);
}

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// ycc_rgb_convert of one pixel.
__device__ __forceinline__ void ycc_rgb(int y, int cb, int cr, int& r, int& g, int& b) {
  cb -= 128;
  cr -= 128;
  r = clamp255(y + ((91881 * cr + 32768) >> 16));
  g = clamp255(y + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  b = clamp255(y + ((116130 * cb + 32768) >> 16));
}

// h2v2_fancy_upsample of one component for a 2x4 patch of output pixels:
// c[row][col], rows (above, here, below), columns (left, 0, 1, right) of the
// chroma samples around the patch's two chroma columns, edges already
// replicated; out[2][4].
__device__ __forceinline__ void fancy_2x4(const int (&c)[3][4], int (&out)[2][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    int col[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) col[i] = 3 * c[1][i] + c[half ? 2 : 0][i];
    out[half][0] = (3 * col[1] + col[0] + 8) >> 4;
    out[half][1] = (3 * col[1] + col[2] + 7) >> 4;
    out[half][2] = (3 * col[2] + col[1] + 8) >> 4;
    out[half][3] = (3 * col[2] + col[3] + 7) >> 4;
  }
}

// ---- the kernel

using lss::cp_async16;
using lss::cp_async_commit;
using lss::cp_async_wait_all;

// A CTA's rectangle of its image and the blocks it decodes.
struct Tile {
  long long first;  // the image's first block in the batch
  int ncomp, hs, vs, fancy;
  int mx, my, across0, n0;  // MCUs across and down; luma blocks a row and in all
  int dsh, dsw;             // chroma samples down and across (libjpeg's)
  int x0, x1, y0, y1;       // output pixels
  int mc0, mc1, mr0, mr1;   // MCUs
  int cc0, cc1, cq0, cq1;   // chroma block columns and rows decoded (halo included)
  int it0;                  // the first step (chroma rows ahead of the first luma row)
};

__device__ __forceinline__ bool make_tile(Tile& t, const int* meta, int img, int height, int width,
                                          int strip_px, int band_px, int s, int b) {
  t.first = meta[4 * img];
  t.ncomp = meta[4 * img + 1];
  t.hs = meta[4 * img + 2];
  t.vs = meta[4 * img + 3];
  t.x0 = s * strip_px;
  t.y0 = b * band_px;
  if (t.x0 >= width || t.y0 >= height) return false;
  t.x1 = min(width, t.x0 + strip_px);
  t.y1 = min(height, t.y0 + band_px);
  const int mw = 8 * t.hs, mh = 8 * t.vs;
  t.mx = (width + mw - 1) / mw;
  t.my = (height + mh - 1) / mh;
  t.across0 = t.mx * t.hs;
  t.n0 = t.across0 * t.my * t.vs;
  t.dsh = t.hs == 2 ? (height + 1) >> 1 : height;
  t.dsw = t.hs == 2 ? (width + 1) >> 1 : width;
  t.mc0 = t.x0 / mw;
  t.mc1 = (t.x1 + mw - 1) / mw;
  t.mr0 = t.y0 / mh;
  t.mr1 = (t.y1 + mh - 1) / mh;
  t.fancy = t.ncomp == 3 && t.hs == 2;
  t.cc0 = t.fancy ? max(t.mc0 - 1, 0) : t.mc0;
  t.cc1 = t.fancy ? min(t.mc1 + 1, t.mx) : t.mc1;
  t.cq0 = t.fancy ? max(t.mr0 - 1, 0) : t.mr0;
  t.cq1 = t.fancy ? min(t.mr1 + 1, t.my) : t.mr1;
  t.it0 = t.fancy ? t.cq0 - 1 : t.mr0;
  return true;
}

// What step `it` decodes: luma MCU row `it` (when it >= mr0) and chroma block
// row q (it + 1 with 4:2:0, it otherwise; when inside [cq0, cq1)).
struct Step {
  int luma, q;  // -1 where none
  int nl, nlr, nc, slots;
};

__device__ __forceinline__ Step make_step(const Tile& t, int it) {
  Step st;
  st.luma = it >= t.mr0 ? it : -1;
  const int q = t.fancy ? it + 1 : it;
  st.q = t.ncomp == 3 && q >= t.cq0 && q < t.cq1 ? q : -1;
  st.nl = (t.mc1 - t.mc0) * t.hs;
  st.nlr = st.luma >= 0 ? t.vs : 0;
  st.nc = st.q >= 0 ? t.cc1 - t.cc0 : 0;
  st.slots = st.nlr * st.nl + 2 * st.nc;
  return st;
}

// A step's slots lie in at most 4 runs of consecutive blocks of the packed
// layout: the luma block rows, then each chroma component's row.
__device__ void load_step(const Tile& t, const Step& st, const int16_t* __restrict__ coefs,
                          unsigned char* smem) {
  const int nluma = st.nlr * st.nl;
  const int s1 = min(st.nl, nluma), s2 = nluma, s3 = nluma + st.nc;  // the runs' first slots
  const long long luma = t.first + (long long)st.luma * t.vs * t.across0 + t.mc0 * t.hs;
  const long long chroma = t.first + t.n0 + (long long)st.q * t.mx + t.cc0;
  for (int ch = threadIdx.x; ch < st.slots * 8; ch += kThreads) {
    const int slot = ch >> 3, part = ch & 7;
    const long long block =
        slot < s1 ? luma + slot
        : slot < s2 ? luma + t.across0 + (slot - s1)
        : slot < s3 ? chroma + (slot - s2)
                    : chroma + (long long)t.mx * t.my + (slot - s3);
    cp_async16(smem + kCoefOffset + slot * kSlotBytes + part * 16, coefs + block * 64 + part * 8);
  }
  cp_async_commit();
}

// Eight threads a block: thread `col` transforms column col, then row col.
__device__ void idct_step(const Tile& t, const Step& st, unsigned char* smem) {
  const int tid = threadIdx.x, col = tid & 7;
  int* ws = reinterpret_cast<int*>(smem + kWsOffset) + (tid >> 3) * kWsWords;
  const int* quant = reinterpret_cast<const int*>(smem + kQuantOffset);
  const int nluma = st.nlr * st.nl;
  for (int base = 0; base < st.slots * 8; base += kThreads) {
    const int slot = (base + tid) >> 3;
    const bool active = slot < st.slots;
    int comp = 0, br = 0, bc = slot;  // at most 2 luma block rows a step
    if (active) {
      if (slot >= nluma) {
        const int k = slot - nluma;
        comp = k < st.nc ? 1 : 2;
        bc = k - (comp - 1) * st.nc;
      } else if (slot >= st.nl) {
        br = 1;
        bc = slot - st.nl;
      }
      const int16_t* c = reinterpret_cast<const int16_t*>(smem + kCoefOffset + slot * kSlotBytes);
      const int* q = quant + comp * 64;
      int v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = c[8 * k + col] * q[8 * k + col];
      idct_1d(v, 11);
#pragma unroll
      for (int k = 0; k < 8; ++k) ws[12 * k + col] = v[k];
    }
    __syncwarp();
    if (active) {
      const int4 a = *reinterpret_cast<const int4*>(ws + 12 * col);
      const int4 b = *reinterpret_cast<const int4*>(ws + 12 * col + 4);
      int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      idct_1d(v, 18);
      const uint32_t lo = range_limit(v[0]) | range_limit(v[1]) << 8 | range_limit(v[2]) << 16 |
                          range_limit(v[3]) << 24;
      const uint32_t hi = range_limit(v[4]) | range_limit(v[5]) << 8 | range_limit(v[6]) << 16 |
                          range_limit(v[7]) << 24;
      unsigned char* dst;
      if (comp == 0) {
        dst = smem + kLumaOffset + (8 * br + col) * kLumaPitch + 8 * bc;
      } else if (t.fancy) {
        dst = smem + kChromaOffset + (comp - 1) * kChromaBytes + (st.q % 3) * kRingBytes +
              col * kChromaPitch + 8 * bc;
      } else {
        dst = smem + kChromaOffset + (comp - 1) * kChromaBytes + col * kLumaPitch + 8 * bc;
      }
      *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
    }
    __syncwarp();
  }
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return static_cast<uint32_t>(a) | static_cast<uint32_t>(b) << 8 | static_cast<uint32_t>(c) << 16 |
         static_cast<uint32_t>(d) << 24;
}

// 4 pixels' RGB (12 bytes) at a 4-byte aligned staging address.
__device__ __forceinline__ void stage4(unsigned char* dst, const int (&r)[4], const int (&g)[4],
                                       const int (&b)[4]) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  d[0] = pack4(r[0], g[0], b[0], r[1]);
  d[1] = pack4(g[1], b[1], r[2], g[2]);
  d[2] = pack4(b[2], r[3], g[3], b[3]);
}

// The step's MCU row into the staging rows: one thread per 4 pixels across and
// 2 rows (4:2:0) or 1 row down.
__device__ void colour_step(const Tile& t, int it, unsigned char* smem) {
  const unsigned char* luma = smem + kLumaOffset;
  const unsigned char* chroma = smem + kChromaOffset;
  unsigned char* stage = smem + kStageOffset;
  const int quads = (t.x1 - t.x0 + 3) >> 2;
  const int rows = t.fancy ? 8 : 8 * t.vs;  // row pairs with 4:2:0
  const int dpr = kThreads / quads, dgx = kThreads - dpr * quads;
  int pr = threadIdx.x / quads, gx = threadIdx.x - pr * quads;
  for (; pr < rows; pr += dpr, gx += dgx, pr += gx >= quads, gx -= gx >= quads ? quads : 0) {
    const int lx = 4 * gx, x = t.x0 + lx;
    if (t.fancy) {
      const int y = 16 * it + 2 * pr;
      if (y >= t.y1) continue;
      const int iy = y >> 1;
      const int ry[3] = {max(iy - 1, 0), iy, min(iy + 1, t.dsh - 1)};
      const int cx = x >> 1;
      int cols[4];
      if (t.dsw > 2) {
        cols[0] = max(cx - 1, 0);
        cols[1] = cx;
        cols[2] = min(cx + 1, t.dsw - 1);
        cols[3] = min(cx + 2, t.dsw - 1);
      }
      int up[2][2][4];  // component, row, pixel
#pragma unroll
      for (int comp = 0; comp < 2; ++comp) {
        const unsigned char* plane = chroma + comp * kChromaBytes;
        if (t.dsw > 2) {
          int c[3][4];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int row =
                ((ry[i] >> 3) % 3) * kRingBytes + (ry[i] & 7) * kChromaPitch - 8 * t.cc0;
#pragma unroll
            for (int j = 0; j < 4; ++j) c[i][j] = plane[row + cols[j]];
          }
          fancy_2x4(c, up[comp]);
        } else {  // chroma at most 2 wide: replicated
          const int row = ((iy >> 3) % 3) * kRingBytes + (iy & 7) * kChromaPitch - 8 * t.cc0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            up[comp][0][j] = up[comp][1][j] = plane[row + min((x + j) >> 1, t.dsw - 1)];
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ly = 2 * pr + half;
        const uint32_t lw = *reinterpret_cast<const uint32_t*>(luma + ly * kLumaPitch + lx);
        int r[4], g[4], b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ycc_rgb((lw >> (8 * j)) & 0xff, up[0][half][j], up[1][half][j], r[j], g[j], b[j]);
        stage4(stage + ly * kStagePitch + 3 * lx, r, g, b);
      }
    } else {
      const int y = 8 * t.vs * it + pr;
      if (y >= t.y1) continue;
      const uint32_t lw = *reinterpret_cast<const uint32_t*>(luma + pr * kLumaPitch + lx);
      int r[4], g[4], b[4];
      if (t.ncomp == 3) {
        const uint32_t cbw =
            *reinterpret_cast<const uint32_t*>(chroma + pr * kLumaPitch + lx);
        const uint32_t crw =
            *reinterpret_cast<const uint32_t*>(chroma + kChromaBytes + pr * kLumaPitch + lx);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ycc_rgb((lw >> (8 * j)) & 0xff, (cbw >> (8 * j)) & 0xff, (crw >> (8 * j)) & 0xff, r[j],
                  g[j], b[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = g[j] = b[j] = (lw >> (8 * j)) & 0xff;
      }
      stage4(stage + pr * kStagePitch + 3 * lx, r, g, b);
    }
  }
}

// The staging rows of the step to the output: 16-byte stores where the
// destination is aligned, bytes at the ends.
__device__ void store_step(const Tile& t, int it, int img, int height, int width,
                           const unsigned char* smem, uint8_t* __restrict__ out) {
  const unsigned char* stage = smem + kStageOffset;
  const int mh = 8 * t.vs, ya = mh * it;
  const int rows = min(t.y1, ya + mh) - ya;
  const int nb = 3 * (t.x1 - t.x0);
  const int chunks = (nb >> 4) + 1;
  const int dr = kThreads / chunks, dk = kThreads - dr * chunks;
  int r = threadIdx.x / chunks, k = threadIdx.x - r * chunks;
  for (; r < rows; r += dr, k += dk, r += k >= chunks, k -= k >= chunks ? chunks : 0) {
    uint8_t* g = out + (((long long)img * height + ya + r) * width + t.x0) * 3;
    const int head = min(nb, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15));
    const int body = (nb - head) >> 4;
    if (k >= body) continue;
    const int off = head + 16 * k;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(stage + r * kStagePitch + (off & ~3));
    const int sh = 8 * (off & 3);
    uint4 v;
    v.x = __funnelshift_r(s[0], s[1], sh);
    v.y = __funnelshift_r(s[1], s[2], sh);
    v.z = __funnelshift_r(s[2], s[3], sh);
    v.w = __funnelshift_r(s[3], s[4], sh);
    *reinterpret_cast<uint4*>(g + off) = v;
  }
  for (int u = threadIdx.x; u < rows * 32; u += kThreads) {
    const int r = u >> 5, i = u & 31;
    uint8_t* g = out + (((long long)img * height + ya + r) * width + t.x0) * 3;
    const int head = min(nb, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15));
    const int tail0 = head + 16 * ((nb - head) >> 4);
    const int off = i < 16 ? i : tail0 + i - 16;
    if ((i < 16 && off < head) || (i >= 16 && off < nb))
      g[off] = stage[r * kStagePitch + off];
  }
}

__global__ void __launch_bounds__(kThreads) jpeg_decode_kernel(
    const int16_t* __restrict__ coefs, const int* __restrict__ quant, const int* __restrict__ meta,
    uint8_t* __restrict__ out, int height, int width, int strip_px, int strips, int band_px) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.y;
  Tile t;
  if (!make_tile(t, meta, img, height, width, strip_px, band_px, blockIdx.x % strips,
                 blockIdx.x / strips))
    return;
  int* q = reinterpret_cast<int*>(smem + kQuantOffset);
  for (int i = threadIdx.x; i < 3 * 64; i += kThreads) q[i] = quant[img * 3 * 64 + i];
  const int last = t.mr1 - 1;
  load_step(t, make_step(t, t.it0), coefs, smem);
  for (int it = t.it0; it <= last; ++it) {
    const Step st = make_step(t, it);
    cp_async_wait_all();
    __syncthreads();  // this step's coefficients are in; the last step's rows are out
    idct_step(t, st, smem);
    __syncthreads();  // the samples are in; the coefficient buffer is free
    if (it < last) load_step(t, make_step(t, it + 1), coefs, smem);
    if (st.luma >= 0) {
      colour_step(t, it, smem);
      __syncthreads();
      store_step(t, it, img, height, width, smem, out);
    }
  }
}

}  // namespace

extern "C" int jpeg_idct_decode(const void* coefs, const void* quant, const void* meta, void* out,
                                int n, int height, int width, int sms, void* stream) {
  if (n <= 0 || n > 65535 || height <= 0 || width <= 0 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // The tiles: strips of at most kStripMax pixels, multiples of 16, as even as
  // they come; bands of whole 16-row MCU rows, as many as make kCtasPerSm CTAs
  // an SM, one at least (a CTA decodes the chroma row above and below its band
  // again: more bands, more repeated work, but shorter walks that balance the
  // SMs).
  const int cols = (width + 15) / 16, rows = (height + 15) / 16;
  const int strips = (cols + kStripMax / 16 - 1) / (kStripMax / 16);
  const int strip_px = 16 * ((cols + strips - 1) / strips);
  const long long fill = static_cast<long long>(kCtasPerSm) * sms / (static_cast<long long>(n) *
                                                                     strips);
  const int want = static_cast<int>(fill < 1 ? 1 : fill < rows ? fill : rows);
  const int band_rows = (rows + want - 1) / want;
  const int bands = (rows + band_rows - 1) / band_rows;
  if (static_cast<long long>(strips) * bands > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      jpeg_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  jpeg_decode_kernel<<<dim3(strips * bands, n), kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coefs), static_cast<const int*>(quant),
      static_cast<const int*>(meta), static_cast<uint8_t*>(out), height, width, strip_px, strips,
      16 * band_rows);
  return static_cast<int>(cudaGetLastError());
}

// ---- the probes: the arithmetic alone, on values in registers, never
// launched (outside the anonymous namespace, so that they are compiled);
// `ops/_build.py::sass_int_ops` counts their integer instructions in the
// built library for `ops/jpeg_idct.py::bound`.

// One block: dequantisation, both passes, the range limit.
extern "C" __global__ void ops_probe_idct_block(const int* __restrict__ in, int* __restrict__ out) {
  int x[8][8];
#pragma unroll
  for (int i = 0; i < 64; ++i) x[i >> 3][i & 7] = in[i] * in[64 + i];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = x[k][c];
    idct_1d(v, 11);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k][c] = v[k];
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    idct_1d(x[r], 18);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[8 * r + k] = range_limit(x[r][k]);
  }
}

// Eight 4:2:0 pixels (2x4): both components' upsampling and the colour.
extern "C" __global__ void ops_probe_pixels_420(const int* __restrict__ in, int* __restrict__ out) {
  int cb[3][4], cr[3][4], ub[2][4], ur[2][4];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    cb[i / 4][i % 4] = in[8 + i];
    cr[i / 4][i % 4] = in[20 + i];
  }
  fancy_2x4(cb, ub);
  fancy_2x4(cr, ur);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    ycc_rgb(in[i], ub[i / 4][i % 4], ur[i / 4][i % 4], out[3 * i], out[3 * i + 1], out[3 * i + 2]);
}

// One 4:4:4 pixel: the colour.
extern "C" __global__ void ops_probe_pixel_444(const int* __restrict__ in, int* __restrict__ out) {
  ycc_rgb(in[0], in[1], in[2], out[0], out[1], out[2]);
}
