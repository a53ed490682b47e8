// BEV segmentation head (eval): Conv3x3(256->128)+ReLU -> Conv3x3(128->64)
// +ReLU -> Conv1x1(64->4), batch norm folded into the convs on the host,
// zero SAME padding.
//
// Replaces the TPU kernel `_kernel` of lss2_multimodal_nu_tpu/ops/
// seg_head_pallas.py (`fused_seg_head`).
//
// Bound on the H100: operations. At the flagship (6 x 200 x 200 pixels) the
// two 3x3 convs are 177 GFLOP against 123 MB of input (float32: 246 MB):
// 0.18 ms at the bf16 peak, 1.07 ms for float32 as three TF32 passes at the
// TF32 peak (2.64 ms at the SIMT float32 peak, the first port's design).
// Both convs are implicit GEMMs over 9 taps, zero outside the image (the
// SAME padding, also for the second conv: its halo is zero and not
// relu(bias)).
//
// Two launches where the TPU kernel keeps the first conv's output on chip:
// launch 1 writes conv0+ReLU to HBM in the working dtype (123 MB in bf16 at
// the flagship, about 0.07 ms of traffic out and back at HBM rate; 246 MB,
// 0.15 ms, in float32); launch 2 fuses conv1+ReLU with the 1x1 head, in
// float32 on the accumulator, and writes float logits as (B, out, H, W).
// Keeping conv0 on chip would recompute it on a halo: 1.41 times its work at
// 8 x 16 output tiles, 1.27 at 16 x 16, more than the round trip costs.
//
// bfloat16 (`bf16k`): tensor cores (wgmma) fed by TMA, each input pixel
// loaded once per 64-channel slice (see the note there).
//
// float (`tf32k`): the same design on TF32 wgmma in three passes
// (hopper.cuh), with 32-channel slices (see the note there); the conv
// kernels are split into hi and lo once per call by a small kernel.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---- bfloat16: warpgroup products fed by TMA -------------------------------
//
// A block of 384 threads owns a 16 x 16 pixel tile of one image. Warpgroups
// 0 and 1 compute, on output rows 8g..8g+7 each, as two wgmma M-tiles of 64
// pixels (rows 8g + 4m .. 8g + 4m + 3; warp w of the warpgroup takes row
// 8g + 4m + w in both). Warpgroup 2 is the producer: one of its threads
// issues every copy and the warpgroup gives its registers to the other two.
// The input is walked in slices of 64 channels: the slice's 18 x 18 halo
// tile arrives once by TMA (a 4-D box over (B, H, W, C) whose out-of-image
// part the TMA fills with zeros, which is the SAME padding), double-
// buffered. The 9 taps read shifted windows of it with ldmatrix (a one-pixel
// shift breaks wgmma's 8-row shared-memory layout, but ldmatrix takes one
// address per row) into the register A operand. The weight tiles, w^T[tap]
// (COUT x 64 channels), stream by TMA through a 4-stage ring in wgmma's
// swizzled B layout. Producer and consumers meet only at the mbarriers of
// the two rings, and a consumer keeps two items' products in flight. Bias
// and ReLU run on the accumulator. At the flagship the pair runs at about
// half the bound; what limits it further is not measured.
namespace bf16k {

using bf16 = __nv_bfloat16;
constexpr int T = 16;                       // output tile, T x T pixels
constexpr int HT = T + 2;                   // halo tile side
constexpr int HALO = (HT * HT * 128 + 1023) / 1024 * 1024;  // one 64-channel slice
constexpr int STAGES = 4;

template <int COUT> struct Smem {
  static constexpr int WT = COUT * 128;  // one (tap, slice) weight tile
  static constexpr int BARS = 2 * HALO + STAGES * WT;
  // mbarriers: halo full/empty (2 each), weight full/empty (STAGES each)
  static constexpr size_t bytes = BARS + (4 + 2 * STAGES) * 8 + 1024;  // + alignment slack
};

// Arrive at the mbarriers that free item i's weight stage (and, after its
// last tap, its halo buffer): lane 0 of each consumer warp.
__device__ __forceinline__ void release(int i, uint32_t halo_empty, uint32_t w_empty) {
  lss::mbar_arrive(w_empty + 8 * (i % STAGES));
  if (i % 9 == 8) lss::mbar_arrive(halo_empty + 8 * ((i / 9) % 2));
}

// Item i of a consumer: wait for its tiles, load the shifted A windows of both
// M-tiles into a, issue the products into acc, then wait out item i - 1's
// (whose A registers are a_prev) and release its tiles.
template <int COUT>
__device__ __forceinline__ void consume(int i, float (&acc)[2][COUT / 2], uint32_t (&a)[2][4][4],
                                        uint32_t (&a_prev)[2][4][4], uint32_t halo,
                                        uint32_t wring, uint32_t halo_full, uint32_t halo_empty,
                                        uint32_t w_full, uint32_t w_empty, int g, int warp, int px,
                                        int khalf, int lane) {
  using namespace lss;
  const int ks = i / 9, t = i % 9, st = i % STAGES;
  if (t == 0) mbar_wait(halo_full + 8 * (ks % 2), (ks / 2) & 1);
  mbar_wait(w_full + 8 * st, (i / STAGES) & 1);
  const uint32_t hb = halo + (ks % 2) * HALO, wb = wring + st * Smem<COUT>::WT;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    // halo pixel of this lane's row: output row 8g + 4m + w, shifted by the tap
    const int hp = (8 * g + 4 * m + warp % 4 + t / 3) * HT + px + t % 3;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[m][kk], hb + sw128(hp, 2 * kk + khalf));
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) fence_regs(acc[m]);
  wgmma_fence();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (COUT == 128) wgmma_rs_n128(acc[m], a[m][kk], desc_sw128(wb + kk * 32));
      else wgmma_rs_n64(acc[m], a[m][kk], desc_sw128(wb + kk * 32));
    }
  wgmma_commit();
  wgmma_wait<1>();  // item i - 1 is done
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a_prev[m][kk]);
  if (i > 0 && lane == 0) release(i - 1, halo_empty, w_empty);
}

// x (B, H, W, CIN) through tm_x, wt (9 COUT, CIN) through tm_w, bias (COUT) float.
// HEAD == false: y (B, H, W, COUT) bf16 = relu(conv(x) + bias).
// HEAD == true:  logits (B, nout, H, W) float = w2^T relu(conv(x) + bias) + b2.
template <int CIN, int COUT, bool HEAD>
__global__ void __launch_bounds__(384, 1)
    conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                        const float* __restrict__ w2, const float* __restrict__ b2,
                        bf16* __restrict__ y, float* __restrict__ logits, int h, int wd,
                        int nout) {
  using namespace lss;
  using L = Smem<COUT>;
  constexpr int NSLICE = CIN / 64, NITEM = 9 * NSLICE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t halo = base, wring = base + 2 * HALO;
  const uint32_t halo_full = base + L::BARS, halo_empty = halo_full + 16,
                 w_full = halo_empty + 16, w_empty = w_full + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = warp / 4;
  const int b = blockIdx.z, y0 = blockIdx.y * T, x0 = blockIdx.x * T;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(halo_full + 8 * i, 1), mbar_init(halo_empty + 8 * i, 8);
    for (int i = 0; i < STAGES; ++i) mbar_init(w_full + 8 * i, 1), mbar_init(w_empty + 8 * i, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (g == 2) {
    // ---- producer. Item i = (channel slice i / 9, tap i % 9): its weight
    // tile, and with tap 0 the slice's halo tile.
    setmaxnreg_dec<24>();
    if (tid == 256) {
      for (int i = 0; i < NITEM; ++i) {
        const int ks = i / 9, t = i % 9;
        if (t == 0) {
          const uint32_t full = halo_full + 8 * (ks % 2);
          if (ks >= 2) mbar_wait(halo_empty + 8 * (ks % 2), ((ks / 2) - 1) & 1);
          mbar_expect_tx(full, HT * HT * 128);
          tma_load_4d(halo + (ks % 2) * HALO, &tm_x, full, ks * 64, x0 - 1, y0 - 1, b);
        }
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(w_empty + 8 * st, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(w_full + 8 * st, L::WT);
        tma_load_2d(wring + st * L::WT, &tm_w, w_full + 8 * st, ks * 64, t * COUT);
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<232>();
    const int px = lane % 16, khalf = lane / 16;
    float acc[2][COUT / 2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < COUT / 2; ++i) acc[m][i] = 0.f;

    // Two items in flight: item i's products are issued before item i - 1's
    // are waited out, so their A registers alternate by name.
    uint32_t a0[2][4][4], a1[2][4][4];
    for (int i = 0; i < NITEM; i += 2) {
      consume<COUT>(i, acc, a0, a1, halo, wring, halo_full, halo_empty, w_full, w_empty, g,
                    warp, px, khalf, lane);
      if (i + 1 < NITEM)
        consume<COUT>(i + 1, acc, a1, a0, halo, wring, halo_full, halo_empty, w_full, w_empty, g,
                      warp, px, khalf, lane);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < 2; ++m) fence_regs(acc[m]);
    if (lane == 0) release(NITEM - 1, halo_empty, w_empty);

    // Epilogue. Accumulator rows l/4 and l/4 + 8 of this warp are pixels
    // l/4 and l/4 + 8 of output row 8g + 4m + w; columns 8j + 2(l%4) + {0,1}.
    const int cq = 2 * (lane % 4);
    const int ox[2] = {x0 + lane / 4, x0 + lane / 4 + 8};
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int oy = y0 + 8 * g + 4 * m + warp % 4;
      if constexpr (!HEAD) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (oy >= h || ox[half] >= wd) continue;
          bf16* dst = y + (((size_t)b * h + oy) * wd + ox[half]) * COUT + cq;
#pragma unroll
          for (int j = 0; j < COUT / 8; ++j) {
            const float v0 = fmaxf(acc[m][4 * j + 2 * half] + bias[8 * j + cq], 0.f);
            const float v1 = fmaxf(acc[m][4 * j + 2 * half + 1] + bias[8 * j + cq + 1], 0.f);
            *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(v0, v1);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < COUT / 2; ++i)
          acc[m][i] = fmaxf(acc[m][i] + bias[8 * (i / 4) + cq + i % 2], 0.f);
        for (int o = 0; o < nout; ++o) {
          float s[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < COUT / 2; ++i)
            s[(i / 2) % 2] = fmaf(acc[m][i], w2[(8 * (i / 4) + cq + i % 2) * nout + o], s[(i / 2) % 2]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
            s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
            if (lane % 4 == 0 && oy < h && ox[half] < wd)
              logits[((size_t)b * nout + o) * h * wd + (size_t)oy * wd + ox[half]] = s[half] + b2[o];
          }
        }
      }
    }
  }
}

template <int CIN, int COUT, bool HEAD>
cudaError_t launch_conv_bf16(const void* x, const void* wt, const void* bias, const void* w2,
                             const void* b2, void* y, void* logits, int b, int h, int wd,
                             int nout, cudaStream_t stream) {
  // x as (B, H, W, CIN) in boxes of one 18 x 18 halo tile of 64 channels; wt
  // as (9 COUT, CIN) in boxes of one (tap, slice) tile
  const cuuint64_t dx[4] = {CIN, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint32_t bx[4] = {64, HT, HT, 1};
  const cuuint64_t dw[2] = {CIN, 9 * COUT};
  const cuuint32_t bw[2] = {64, COUT};
  CUtensorMap tm_x, tm_w;
  cudaError_t e = lss::tensor_map(&tm_x, x, 4, dx, bx);
  if (e == cudaSuccess) e = lss::tensor_map(&tm_w, wt, 2, dw, bw);
  constexpr size_t bytes = Smem<COUT>::bytes;
  auto kern = conv3x3_bf16_kernel<CIN, COUT, HEAD>;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((wd + T - 1) / T, (h + T - 1) / T, b);
  kern<<<grid, 384, bytes, stream>>>(tm_x, tm_w, (const float*)bias, (const float*)w2,
                                     (const float*)b2, (bf16*)y, (float*)logits, h, wd, nout);
  return cudaGetLastError();
}

}  // namespace bf16k

// ---- float: TF32 warpgroup products in three passes, fed by TMA ------------
//
// The bf16 design with float operands: 16 x 16 pixel tiles, two consumer
// warpgroups of two M-tiles each, a producer warpgroup, the halo tile by one
// 4-D TMA box whose zero fill is the SAME padding, double-buffered. What
// changes: the input is walked in 32-channel slices (one 128-byte swizzled
// row of floats per pixel, 18 x 18 x 32 x 4 B = 41.5 KB a halo tile), and a
// weight item is the (tap, slice) tile w^T[tap] (COUT x 32) in hi and lo, 32
// KB for conv0 (4 stages) and 16 KB for conv1 (8 stages). The taps' shifted
// windows are read with the same ldmatrix as bf16's, which gives the TF32 A
// fragment of a float tile (hopper.cuh), split into hi and lo in registers.
// A consumer keeps one group of products (one M-tile, two k-steps, three
// passes) in flight while it loads and splits the next group's A.
namespace tf32k {

constexpr int T = 16;                                       // output tile, T x T pixels
constexpr int HT = T + 2;                                   // halo tile side
constexpr int HALO = (HT * HT * 128 + 1023) / 1024 * 1024;  // one 32-channel slice

template <int COUT> struct Smem {
  static constexpr int WT = COUT * 128;      // one (tap, slice) tile, hi or lo
  static constexpr int ITEM = 2 * WT;        // hi, then lo
  static constexpr int STAGES = 512 / COUT;  // 4 for conv0, 8 for conv1
  static constexpr int BARS = 2 * HALO + STAGES * ITEM;
  // mbarriers: halo full/empty (2 each), weight full/empty (STAGES each)
  static constexpr size_t bytes = BARS + (4 + 2 * STAGES) * 8 + 1024;  // + alignment slack
  static_assert(bytes <= 232448, "over the H100's 227 KB of shared memory a block");
};

// x (B, H, W, CIN) float through tm_x, ws (2, 9 COUT, CIN) the hi and lo of
// w^T through tm_w, bias (COUT) float.
// HEAD == false: y (B, H, W, COUT) float = relu(conv(x) + bias).
// HEAD == true:  logits (B, nout, H, W) float = w2^T relu(conv(x) + bias) + b2.
template <int CIN, int COUT, bool HEAD>
__global__ void __launch_bounds__(384, 1)
    conv3x3_tf32_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                        const float* __restrict__ w2, const float* __restrict__ b2,
                        float* __restrict__ y, float* __restrict__ logits, int h, int wd,
                        int nout) {
  using namespace lss;
  using L = Smem<COUT>;
  constexpr int NSLICE = CIN / 32, NITEM = 9 * NSLICE, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t halo = base, wring = base + 2 * HALO;
  const uint32_t halo_full = base + L::BARS, halo_empty = halo_full + 16,
                 w_full = halo_empty + 16, w_empty = w_full + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = warp / 4;
  const int b = blockIdx.z, y0 = blockIdx.y * T, x0 = blockIdx.x * T;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(halo_full + 8 * i, 1), mbar_init(halo_empty + 8 * i, 8);
    for (int i = 0; i < STAGES; ++i) mbar_init(w_full + 8 * i, 1), mbar_init(w_empty + 8 * i, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (g == 2) {
    // ---- producer. Item i = (channel slice i / 9, tap i % 9): its weight
    // tile's hi and lo, and with tap 0 the slice's halo tile.
    setmaxnreg_dec<24>();
    if (tid == 256) {
      for (int i = 0; i < NITEM; ++i) {
        const int ks = i / 9, t = i % 9;
        if (t == 0) {
          const uint32_t full = halo_full + 8 * (ks % 2);
          if (ks >= 2) mbar_wait(halo_empty + 8 * (ks % 2), ((ks / 2) - 1) & 1);
          mbar_expect_tx(full, HT * HT * 128);
          tma_load_4d(halo + (ks % 2) * HALO, &tm_x, full, ks * 32, x0 - 1, y0 - 1, b);
        }
        const int st = i % STAGES;
        const uint32_t dst = wring + st * L::ITEM, full = w_full + 8 * st;
        if (i >= STAGES) mbar_wait(w_empty + 8 * st, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full, L::ITEM);
        tma_load_2d(dst, &tm_w, full, ks * 32, t * COUT);
        tma_load_2d(dst + L::WT, &tm_w, full, ks * 32, (9 + t) * COUT);
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<232>();
    const int px = lane % 16, khalf = lane / 16;
    float acc[2][COUT / 2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < COUT / 2; ++i) acc[m][i] = 0.f;

    // lane 0 of each warp frees item i's weight stage and, after its last
    // tap, its halo buffer
    auto release = [&](int i) {
      mbar_arrive(w_empty + 8 * (i % STAGES));
      if (i % 9 == 8) mbar_arrive(halo_empty + 8 * ((i / 9) % 2));
    };
    uint32_t ahi[2][8], alo[2][8];  // A of two groups, alternating by k-step pair
#pragma unroll 1
    for (int i = 0; i < NITEM; ++i) {
      const int ks = i / 9, t = i % 9, st = i % STAGES;
      if (t == 0) mbar_wait(halo_full + 8 * (ks % 2), (ks / 2) & 1);
      mbar_wait(w_full + 8 * st, (i / STAGES) & 1);
      const uint32_t hb = halo + (ks % 2) * HALO, wb = wring + st * L::ITEM;
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        const int m = grp / 2, kp = grp % 2;
        // halo pixel of this lane's row: output row 8g + 4m + w, shifted by the tap
        const int hp = (8 * g + 4 * m + warp % 4 + t / 3) * HT + px + t % 3;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t raw[4];
          ldmatrix_x4(raw, hb + sw128(hp, 2 * (2 * kp + q) + khalf));
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(raw[e], ahi[kp][4 * q + e], alo[kp][4 * q + e]);
        }
        fence_regs(acc[m]);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kk = 2 * kp + q;
          wgmma_tf32x3<COUT>(acc[m], &ahi[kp][4 * q], &alo[kp][4 * q], desc_sw128(wb + kk * 32),
                             desc_sw128(wb + L::WT + kk * 32));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group before this one is done
        fence_regs(ahi[1 - kp]);
        fence_regs(alo[1 - kp]);
        if (grp == 0 && i > 0 && lane == 0) release(i - 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < 2; ++m) fence_regs(acc[m]);
    fence_regs(ahi[1]);
    fence_regs(alo[1]);
    if (lane == 0) release(NITEM - 1);

    // Epilogue. Accumulator rows l/4 and l/4 + 8 of this warp are pixels
    // l/4 and l/4 + 8 of output row 8g + 4m + w; columns 8j + 2(l%4) + {0,1}.
    const int cq = 2 * (lane % 4);
    const int ox[2] = {x0 + lane / 4, x0 + lane / 4 + 8};
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int oy = y0 + 8 * g + 4 * m + warp % 4;
      if constexpr (!HEAD) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (oy >= h || ox[half] >= wd) continue;
          float* dst = y + (((size_t)b * h + oy) * wd + ox[half]) * COUT + cq;
#pragma unroll
          for (int j = 0; j < COUT / 8; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j) =
                make_float2(fmaxf(acc[m][4 * j + 2 * half] + bias[8 * j + cq], 0.f),
                            fmaxf(acc[m][4 * j + 2 * half + 1] + bias[8 * j + cq + 1], 0.f));
        }
      } else {
#pragma unroll
        for (int i = 0; i < COUT / 2; ++i)
          acc[m][i] = fmaxf(acc[m][i] + bias[8 * (i / 4) + cq + i % 2], 0.f);
        for (int o = 0; o < nout; ++o) {
          float s[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < COUT / 2; ++i)
            s[(i / 2) % 2] = fmaf(acc[m][i], w2[(8 * (i / 4) + cq + i % 2) * nout + o], s[(i / 2) % 2]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
            s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
            if (lane % 4 == 0 && oy < h && ox[half] < wd)
              logits[((size_t)b * nout + o) * h * wd + (size_t)oy * wd + ox[half]] = s[half] + b2[o];
          }
        }
      }
    }
  }
}

template <int CIN, int COUT, bool HEAD>
cudaError_t launch_conv_tf32(const void* x, const void* ws, const void* bias, const void* w2,
                             const void* b2, void* y, void* logits, int b, int h, int wd,
                             int nout, cudaStream_t stream) {
  // x as (B, H, W, CIN) in boxes of one 18 x 18 halo tile of 32 channels; ws
  // as (2 x 9 COUT, CIN) in boxes of one (tap, slice) tile
  constexpr auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dx[4] = {CIN, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint32_t bx[4] = {32, HT, HT, 1};
  const cuuint64_t dw[2] = {CIN, 2 * 9 * COUT};
  const cuuint32_t bw[2] = {32, COUT};
  CUtensorMap tm_x, tm_w;
  cudaError_t e = lss::tensor_map(&tm_x, x, 4, dx, bx, f32);
  if (e == cudaSuccess) e = lss::tensor_map(&tm_w, ws, 2, dw, bw, f32);
  constexpr size_t bytes = Smem<COUT>::bytes;
  auto kern = conv3x3_tf32_kernel<CIN, COUT, HEAD>;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((wd + T - 1) / T, (h + T - 1) / T, b);
  kern<<<grid, 384, bytes, stream>>>(tm_x, tm_w, (const float*)bias, (const float*)w2,
                                     (const float*)b2, (float*)y, (float*)logits, h, wd, nout);
  return cudaGetLastError();
}

}  // namespace tf32k

// The conv kernels' hi/lo split (one launch for both): w0 (9, 256, 128) ->
// w0s (2, 9, 128, 256), w1 (9, 128, 64) -> w1s (2, 9, 64, 128), each as hi
// over lo of the kernel with its channel axes swapped (output channel first).
int split_f32(const void* w0, const void* w1, void* w0s, void* w1s, void* stream) {
  float* a = (float*)w0s;
  float* c = (float*)w1s;
  return (int)lss::split_weights(lss::SplitJob{(const float*)w0, a, a + 9 * 128 * 256, 9, 256, 128, 0},
                                 lss::SplitJob{(const float*)w1, c, c + 9 * 64 * 128, 9, 128, 64, 0},
                                 (cudaStream_t)stream);
}

// Two launches after the split: conv0 (256 -> 128) into y0, then conv1 (128
// -> 64) + head.
int launch_f32(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
               const void* w2, const void* b2, void* w0s, void* w1s, void* y0, void* logits,
               int b, int h, int wd, int nout, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int code = split_f32(w0, w1, w0s, w1s, stream);
  if (code != 0) return code;
  cudaError_t e = tf32k::launch_conv_tf32<256, 128, false>(x, w0s, b0, nullptr, nullptr, y0,
                                                           nullptr, b, h, wd, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)tf32k::launch_conv_tf32<128, 64, true>(y0, w1s, b1, w2, b2, nullptr, logits, b, h,
                                                     wd, nout, s);
}

// The same two launches; w0t (9, 128, 256) and w1t (9, 64, 128) are the
// kernels with the channel axes swapped (output channel first).
int launch_bf16(const void* x, const void* w0t, const void* b0, const void* w1t, const void* b1,
                const void* w2, const void* b2, void* y0, void* logits, int b, int h, int wd,
                int nout, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = bf16k::launch_conv_bf16<256, 128, false>(x, w0t, b0, nullptr, nullptr, y0,
                                                           nullptr, b, h, wd, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)bf16k::launch_conv_bf16<128, 64, true>(y0, w1t, b1, w2, b2, nullptr, logits, b, h,
                                                     wd, nout, s);
}

}  // namespace

// float32: w0 (9, 256, 128) and w1 (9, 128, 64) as given; w0s (2, 9, 128, 256)
// and w1s (2, 9, 64, 128) are scratch for their split.
extern "C" int seg_head_f32(const void* x, const void* w0, const void* b0, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* w0s, void* w1s,
                            void* y0, void* logits, int b, int h, int w, int nout, void* stream) {
  return launch_f32(x, w0, b0, w1, b1, w2, b2, w0s, w1s, y0, logits, b, h, w, nout, stream);
}

// The split alone, for the tests.
extern "C" int seg_head_split_f32(const void* w0, const void* w1, void* w0s, void* w1s,
                                  void* stream) {
  return split_f32(w0, w1, w0s, w1s, stream);
}

extern "C" int seg_head_bf16(const void* x, const void* w0, const void* b0, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* y0,
                             void* logits, int b, int h, int w, int nout, void* stream) {
  return launch_bf16(x, w0, b0, w1, b1, w2, b2, y0, logits, b, h, w, nout, stream);
}
