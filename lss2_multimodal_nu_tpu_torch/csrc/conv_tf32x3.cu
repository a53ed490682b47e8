// Kernel 8: the float32 convolutions of the VoVNet trunk (`nn/vovnet.py`,
// every `ConvBnAct` whose input is a float32 CUDA tensor, through
// `ops/conv.py::conv2d_tf32x3`) as implicit GEMMs on the tensor cores, each
// product in three TF32 passes (hopper.cuh), as close as a float32 one.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It was added because, under the port's float32 pin (TF32 off), cuDNN's
// heuristic takes FFT tiling for the trunk and runs it at about 2% of the
// card's TF32 tensor-core rate (PERF.md, kernel 8).
//
// Bound on the H100: operations. The eval trunk's convs at 48 images of
// 128 x 352 are 562 GFLOP, 3.4 ms at 495/3 TFLOP/s (three TF32 passes);
// their activations cross memory once in and once out, about 0.3 ms at
// 3.35 TB/s. What the design does about it:
//
// * A block of 384 threads computes 128 * MT output pixels by N output
//   channels (M = pixels, N = Cout, K = Cin x taps). Warpgroups 0 and 1
//   each hold MT wgmma M-tiles of 64 pixels by N in registers; warpgroup 2
//   produces: its warp 0 streams the weight tiles by TMA, its warps 1-3 copy
//   the input tile into shared memory with 4-byte cp.async.
// * The input stays NCHW in memory; the copy lays it out as one 128-byte
//   row of 32 channels per pixel in the 128-byte swizzle (`sw128`), which is
//   the layout ldmatrix turns into the TF32 A fragment (hopper.cuh). Eight
//   lanes copy eight neighbouring pixels of one channel (32 contiguous bytes
//   read, eight bank groups written).
// * 3x3: the input tile is the output tile's halo, read once per 32-channel
//   slice and used by all 9 taps: a tap is an offset of the ldmatrix row
//   addresses, a stride of 2 a factor in them. Output tiles are th x tw
//   pixels of the images stacked row on row, so that narrow late stages
//   fill whole 64-row M-tiles; a tile that crosses into the next image reads
//   that image's zero padding rows in between (`ops/conv.py::plan`).
// * Weights are split once per call into TF32 hi and lo, (2, taps, Cout,
//   Cin) K-major, and each (slice, tap) item's N x 32 hi and lo tiles arrive
//   by TMA, 128-byte swizzled, into a ring of stages: the wgmma B operand.
//   Channels past Cin and rows past Cout arrive as TMA's zeros.
// * Activations are split into hi and lo in registers after ldmatrix; lo
//   is rounded to TF32 (`split_tf32_rn`), weights' and activations' alike.
// * The tensor cores add into their accumulator with truncation, so the sum
//   of a long K kept there drifts towards zero (1e-5 of the output at K =
//   1152, ten times cuDNN's float32 error). Each (slice, tap) item's 4
//   k-steps x 3 passes go into a partial sum of 64 (or 32) columns, which
//   the CUDA cores add to the float32 accumulator, rounded to nearest.
//   Within an item the eight cross-term steps (a_lo b_hi, a_hi b_lo) come
//   first, while the partial sum is about 2^-11 of the products and each
//   truncation costs next to nothing, then the four a_hi b_hi steps: four
//   truncations at full size an item, where the three passes of each
//   k-step in turn would make eleven, and about half the error.
// * Every output element is one accumulator summed in one fixed order, over
//   slices, taps, k-steps and the three passes: no atomics, no split of K,
//   so a call repeats bit for bit.
// * The epilogue adds the bias and applies ReLU where asked (eval, batch
//   norm folded) and stores NCHW: 8 neighbouring pixels of a channel per 8
//   lanes.
// * The host picks the instantiation (MT, N) and the tile shape per conv
//   (`plan`) so that few blocks idle in the last wave: at stage 3's 8,448
//   output pixels, 44 tiles of 256 pixels by 3 of 64 channels make 132
//   blocks, one per SM.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---- TF32 wgmma at the N of a partial sum (64, or 32) ----------------------
//
// D (64 x N, float) += A (64 x 8, tf32, registers) B (8 x N, tf32, K-major
// shared memory through `desc_b`), issued by a whole warpgroup; scale_d == 0
// overwrites D. The operand lists are written out in full, as inline PTX
// needs them.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t* a, uint64_t desc_b, int scale_d);

template <> __device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// x = hi + lo with hi = x rounded to TF32 (hopper.cuh::split_tf32) and lo =
// x - hi rounded to TF32 as well, to nearest (ties away from zero), where
// the tensor cores would truncate it: hi + lo then errs by half a TF32 ulp
// of lo, at most 2^-22 of x, half of what truncation gives.
__device__ __forceinline__ void split_tf32_rn(uint32_t x, uint32_t& hi, uint32_t& lo) {
  lss::split_tf32(x, hi, lo);
  lo = (lo + 0x1000u) & 0xFFFFE000u;
}

// 4 (16) bytes from global into shared memory, or zeros where !ok.
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
// Arrive at `bar` once this thread's earlier cp.async copies have landed
// (the barrier counts the arrival in its expected count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* tmap, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(tmap), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

struct Conv {
  const float* x;        // (b, c, h, w)
  const float* bias;     // (k) or null
  float* y;              // (b, k, oh, ow)
  int b, c, h, w;
  int k, oh, ow;
  int th, tw;            // 3x3: output tile, th stacked rows x tw columns
  int hrows, hcols;      // 3x3: the halo in shared memory
  int hp;                // 3x3: padded input rows an image takes (h + 2)
  int col_tiles, n_tiles;
  int abytes, bst;       // bytes of one input tile; weight stages
  int relu;
};

constexpr int kLoaders = 96;  // warps 1-3 of the producer warpgroup

template <int KS, int S, int MT, int N>
__global__ void __launch_bounds__(384, 1)
    conv_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_w, const Conv p) {
  using namespace lss;
  constexpr int TAPS = KS * KS, AST = KS == 3 ? 2 : 4, BM = 128 * MT;
  constexpr int WT = N * 128;                  // one (tap, slice) weight tile, hi or lo
  constexpr int NC = N % 64 == 0 ? 64 : 32;    // columns a partial sum covers
  // 1x1: the input tile is 32 channel rows of BM + 8 pixels (the 8 put a
  // fragment's four channels on distinct banks)
  constexpr int PITCH = BM + 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t abase = base, wring = base + AST * p.abytes;
  const uint32_t a_full = wring + p.bst * 2 * WT, a_empty = a_full + 8 * AST,
                 w_full = a_empty + 8 * AST, w_empty = w_full + 8 * p.bst;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = warp / 4;
  const int nslice = (p.c + 31) / 32, nitem = nslice * TAPS;
  const int n0 = (blockIdx.x % p.n_tiles) * N, m_tile = blockIdx.x / p.n_tiles;
  const long long hw = (long long)p.h * p.w, ohw = (long long)p.oh * p.ow;
  // 3x3: the tile's first stacked output row and column, and the padded
  // input row where its halo starts. 1x1: its first flattened pixel.
  int r0 = 0, c0 = 0, hbase = 0;
  long long p0 = 0;
  if constexpr (KS == 3) {
    r0 = (m_tile / p.col_tiles) * p.th;
    c0 = (m_tile % p.col_tiles) * p.tw;
    hbase = (r0 / p.oh) * p.hp + S * (r0 % p.oh);
  } else {
    p0 = (long long)m_tile * BM;
  }

  if (tid == 0) {
    for (int i = 0; i < AST; ++i) mbar_init(a_full + 8 * i, kLoaders), mbar_init(a_empty + 8 * i, 8);
    for (int i = 0; i < p.bst; ++i) mbar_init(w_full + 8 * i, 1), mbar_init(w_empty + 8 * i, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (g == 2) {
    setmaxnreg_dec<40>();
    if (warp == 8) {
      // ---- weights. Item i = (channel slice i / TAPS, tap i % TAPS): its
      // N x 32 tile of hi, then of lo.
      if (lane == 0) {
        for (int i = 0; i < nitem; ++i) {
          const int ks = i / TAPS, t = i % TAPS, st = i % p.bst;
          if (i >= p.bst) mbar_wait(w_empty + 8 * st, ((i / p.bst) - 1) & 1);
          const uint32_t dst = wring + st * 2 * WT, full = w_full + 8 * st;
          mbar_expect_tx(full, 2 * WT);
          tma_load_3d(dst, &tm_w, full, ks * 32, n0, t);
          tma_load_3d(dst + WT, &tm_w, full, ks * 32, n0, TAPS + t);
        }
      }
    } else {
      // ---- the input tile of each channel slice
      const int lt = tid - 288;
      for (int ks = 0; ks < nslice; ++ks) {
        const int s = ks % AST;
        if (ks >= AST) mbar_wait(a_empty + 8 * s, ((ks / AST) - 1) & 1);
        const uint32_t buf = abase + s * p.abytes;
        if constexpr (KS == 3) {
          // halo pixel j0 + l % 8, channels 4q + l / 8 (q = 0..7) of the
          // slice: a 128-byte swizzled row of 32 channels per pixel
          const int npix = p.hrows * p.hcols, cb = ks * 32 + lane / 8;
          for (int j = (lt / 32) * 8 + lane % 8; j < npix; j += kLoaders / 4) {
            const int r = j / p.hcols, prow = hbase + r;
            const int bb = prow / p.hp, iy = prow - bb * p.hp - 1;
            const int ix = S * c0 + (j - r * p.hcols) - 1;
            const bool ok = bb < p.b && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
            const long long off = bb * (long long)p.c * hw + (long long)iy * p.w + ix;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int c = cb + 4 * q;
              const bool okc = ok && c < p.c;
              cp_async4_zfill(buf + sw128(j, q) + 4 * (lane / 8), okc ? p.x + off + c * hw : p.x,
                              okc);
            }
          }
        } else {
          // 16 bytes (4 pixels of one channel) a copy: channel row e / (BM/4)
          // of the tile, pixels 4 (e % (BM/4)) + 0..3 (h w is a multiple of 4)
          for (int e = lt; e < 8 * BM; e += kLoaders) {
            const int ch = e / (BM / 4), q4 = e % (BM / 4), c = ks * 32 + ch;
            const long long pix = p0 + 4 * q4, bb = pix / hw;
            const bool ok = bb < p.b && c < p.c;
            cp_async16_zfill(buf + 4 * (ch * PITCH + 4 * q4),
                             ok ? p.x + bb * p.c * hw + c * hw + (pix - bb * hw) : p.x, ok);
          }
        }
        cp_async_arrive(a_full + 8 * s);
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<232>();
    // This lane's A rows: 3x3, the halo row of the top-left tap of its
    // ldmatrix row (pixel) in each M-tile (rows past the tile read row 0;
    // their results are never stored); 1x1, the tile's pixel of fragment
    // row l/4.
    int hp0[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if constexpr (KS == 3) {
        const int mrow = (g * MT + m) * 64 + 16 * (warp % 4) + lane % 16;
        const int tr = mrow / p.tw, tc = mrow - tr * p.tw, rr = r0 + tr;
        hp0[m] = tr < p.th && rr < p.b * p.oh
                     ? ((rr / p.oh) * p.hp + S * (rr % p.oh) - hbase) * p.hcols + S * tc
                     : 0;
      } else {
        hp0[m] = (g * MT + m) * 64 + 16 * (warp % 4) + lane / 4;
      }
    }
    float acc[MT][N / 2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;

    // each item's products go into part (NC columns at a time), then into
    // acc by the CUDA cores (see the note at the top)
    float part[NC / 2];
    uint32_t ahi[4][4], alo[4][4];  // A of the item's four k-steps, one M-tile
#pragma unroll 1
    for (int i = 0; i < nitem; ++i) {
      const int ks = i / TAPS, t = i % TAPS, st = i % p.bst;
      if (t == 0) mbar_wait(a_full + 8 * (ks % AST), (ks / AST) & 1);
      mbar_wait(w_full + 8 * st, (i / p.bst) & 1);
      const uint32_t ab = abase + (ks % AST) * p.abytes, wb = wring + st * 2 * WT;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t raw[4];
          if constexpr (KS == 3) {
            const int hp = hp0[m] + (t / 3) * p.hcols + t % 3;
            ldmatrix_x4(raw, ab + sw128(hp, 2 * kk + lane / 16));
          } else {
            // a0 (row l/4, k l%4), a1 (row + 8), a2 (k + 4), a3 (both)
            const uint32_t a = ab + 4 * ((8 * kk + lane % 4) * PITCH + hp0[m]);
            raw[0] = lds32(a);
            raw[1] = lds32(a + 4 * 8);
            raw[2] = lds32(a + 4 * 4 * PITCH);
            raw[3] = lds32(a + 4 * (4 * PITCH + 8));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32_rn(raw[e], ahi[kk][e], alo[kk][e]);
        }
#pragma unroll
        for (int cn = 0; cn < N / NC; ++cn) {
          const uint32_t wc = wb + cn * NC * 128;
          wgmma_fence();
          // the cross terms of the four k-steps, then a_hi b_hi (the note at
          // the top); the first step overwrites part
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_tf32<NC>(part, alo[kk], desc_sw128(wc + kk * 32), kk == 0 ? 0 : 1);
            wgmma_tf32<NC>(part, ahi[kk], desc_sw128(wc + WT + kk * 32), 1);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_tf32<NC>(part, ahi[kk], desc_sw128(wc + kk * 32), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int j = 0; j < NC / 2; ++j) acc[m][cn * NC / 2 + j] += part[j];
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(ahi[kk]);
          fence_regs(alo[kk]);
        }
      }
      // lane 0 of each warp frees the item's weight stage and, after its
      // last tap, its input tile
      if (lane == 0) {
        mbar_arrive(w_empty + 8 * st);
        if (t == TAPS - 1) mbar_arrive(a_empty + 8 * (ks % AST));
      }
    }

    // Epilogue. Accumulator rows l/4 and l/4 + 8 of warp w's 16 are pixels
    // 16w + l/4 (+ 8) of the M-tile; columns 8j + 2(l%4) + {0,1}.
    long long off[MT][2];
    bool ok[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int mrow = (g * MT + m) * 64 + 16 * (warp % 4) + lane / 4 + 8 * half;
        if constexpr (KS == 3) {
          const int tr = mrow / p.tw, rr = r0 + tr, ox = c0 + mrow - tr * p.tw;
          ok[m][half] = tr < p.th && rr < p.b * p.oh && ox < p.ow;
          off[m][half] = (rr / p.oh) * (long long)p.k * ohw + (long long)(rr % p.oh) * p.ow + ox;
        } else {
          const long long pix = p0 + mrow, bb = pix / ohw;
          ok[m][half] = bb < p.b;
          off[m][half] = bb * (long long)p.k * ohw + (pix - bb * ohw);
        }
      }
    const int cq = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + cq + e;
        if (n >= p.k) continue;
        const float bn = p.bias != nullptr ? p.bias[n] : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (!ok[m][half]) continue;
            float v = acc[m][4 * j + 2 * half + e];
            if (p.bias != nullptr) v += bn;
            if (p.relu) v = fmaxf(v, 0.f);
            p.y[off[m][half] + n * ohw] = v;
          }
      }
  }
}

template <int KS, int S, int MT, int N>
cudaError_t launch(const Conv& p, const void* ws, int m_tiles, cudaStream_t stream) {
  constexpr int AST = KS == 3 ? 2 : 4;
  // the split weights as (Cin, Cout, 2 taps), innermost first, in boxes of
  // one (slice, tap) tile of 32 channels by N outputs
  const cuuint64_t dims[3] = {(cuuint64_t)p.c, (cuuint64_t)p.k, (cuuint64_t)(2 * KS * KS)};
  const cuuint32_t box[3] = {32, N, 1};
  CUtensorMap tm;
  cudaError_t e = lss::tensor_map(&tm, ws, 3, dims, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e != cudaSuccess) return e;
  const size_t bytes = (size_t)AST * p.abytes + (size_t)p.bst * 2 * N * 128 +
                       8 * 2 * (AST + p.bst) + 1024;
  if (bytes > 232448 || p.abytes % 1024 != 0 || p.bst < 2 || p.bst > 8)
    return cudaErrorInvalidValue;
  auto kern = conv_tf32x3_kernel<KS, S, MT, N>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  kern<<<m_tiles * p.n_tiles, 384, bytes, stream>>>(tm, p);
  return cudaGetLastError();
}

// The instantiations of `ops/conv.py::KERNELS`.
cudaError_t dispatch(int ks, int s, int mt, int n, const Conv& p, const void* ws, int m_tiles,
                     cudaStream_t st) {
#define CONV_CASE(KS, S, MT, N) \
  if (ks == KS && s == S && mt == MT && n == N) return launch<KS, S, MT, N>(p, ws, m_tiles, st);
  CONV_CASE(3, 1, 2, 64)
  CONV_CASE(3, 1, 2, 128)
  CONV_CASE(3, 1, 1, 32)
  CONV_CASE(3, 2, 1, 128)
  CONV_CASE(1, 1, 2, 128)
  CONV_CASE(1, 1, 1, 160)
  CONV_CASE(1, 1, 1, 192)
#undef CONV_CASE
  return cudaErrorInvalidValue;
}

// ws (2, taps, k, c) = hi over lo of w (k, c, taps) (`split_tf32_rn`).
__global__ void __launch_bounds__(256) split_kernel(const float* __restrict__ w, float* __restrict__ ws,
                                                    int k, int c, int taps) {
  const long long total = (long long)taps * k * c;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < total; e += gridDim.x * 256LL) {
    const long long t = e / ((long long)k * c), nc = e - t * k * c;
    uint32_t hi, lo;
    split_tf32_rn(__float_as_uint(w[nc * taps + t]), hi, lo);
    ws[e] = __uint_as_float(hi);
    ws[total + e] = __uint_as_float(lo);
  }
}

}  // namespace

// The weight's split: w (k, c, taps) float -> ws (2, taps, k, c).
extern "C" int conv_tf32x3_split(const void* w, void* ws, int k, int c, int taps, void* stream) {
  const long long total = (long long)taps * k * c;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  split_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)w, (float*)ws, k, c, taps);
  return (int)cudaGetLastError();
}

// y (b, k, oh, ow) = conv(x (b, c, h, w), the split weight ws) (+ bias)
// (+ ReLU), NCHW, contiguous, float32; the tiling from `ops/conv.py::plan`.
extern "C" int conv_tf32x3_f32(const void* x, const void* ws, const void* bias, void* y, int b,
                               int c, int h, int w, int k, int oh, int ow, int ks, int stride,
                               int mt, int n, int th, int tw, int hrows, int hcols, int hp,
                               int col_tiles, int m_tiles, int n_tiles, int abytes, int bst,
                               int relu, void* stream) {
  const Conv p{(const float*)x, (const float*)bias, (float*)y, b, c, h, w, k, oh, ow, th, tw,
               hrows, hcols, hp, col_tiles, n_tiles, abytes, bst, relu};
  return (int)dispatch(ks, stride, mt, n, p, ws, m_tiles, (cudaStream_t)stream);
}
