// Fused transformer-encoder tail (eval): LN1 -> Linear -> GELU(erf) ->
// Linear -> residual -> LN2.
//
// Replaces the TPU kernel `_kernel` of lss2_multimodal_nu_tpu/ops/
// ffn_pallas.py (`fused_ffn_ln`). Per row u of (rows, C):
//
//   s   = LN1(u)                               (float statistics)
//   out = LN2(s + W2^T gelu(W1^T s + b1) + b2)
//
// Matrix operands are in the compute dtype with float accumulation; the
// layer norms and the GELU run in float; LayerNorm eps is a parameter. The
// residual adds the float s, not its rounded copy.
//
// Bound on the H100: operations. At the flagship (240 000 x 256 rows, hidden
// 1024) the two products are 252 GFLOP against 246 MB of rows in and out,
// so the tensor cores set the floor (0.25 ms at the bf16 peak). Both
// instantiations keep the 1024-wide hidden activation on chip, which is what
// the fusion is for.
//
// bfloat16 (below, `bf16k`): warpgroup products (wgmma) fed by TMA. A
// producer warpgroup loads each block's 128-row u tile and streams the
// weights through a 2-stage ring in wgmma's swizzled layout, with mbarriers;
// two consumer warpgroups of 64 rows each run product 1 from shared memory,
// GELU in registers, and product 2 with the GELU output as the register A
// operand, and LN2 on the accumulator. What holds it back now is the GELU:
// erff for 246 M hidden values costs about a third of the kernel's time and
// runs while the tensor cores wait, as both consumers reach it together.
//
// float: the SIMT design of the first port, kept as the full-float32 parity
// path: a block owns 64 rows, walks the hidden width in chunks of 64 with
// FMA tile products and the y accumulator in registers; weight tiles are
// staged through shared memory. It is slower than cuBLAS's float32 products.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int C = 256;    // model width
constexpr int F = 1024;   // hidden width
constexpr int M = 64;     // rows per block
constexpr int FC = 64;    // hidden chunk
constexpr int KC = 32;    // depth of a staged weight tile
constexpr int LDS = C + 4;   // float rows: s, then s + y
constexpr int LDA = C + 8;   // rows of s, the A operand of product 1
constexpr int LDH = FC + 4;  // float hidden chunk
constexpr int LDG = FC + 8;  // GELU output, the A operand of product 2
constexpr int LDW = C + 8;   // staged weight tile (width FC or C)

constexpr size_t SMEM_F32 = lss::region<float>(M * LDS) + lss::region<float>(M * LDA) +
                            lss::region<float>(M * LDH) + lss::region<float>(M * LDG) +
                            lss::region<float>(KC * LDW);

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__global__ void __launch_bounds__(lss::kThreads)
    ffn_ln_kernel(const float* __restrict__ u, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ g1,
                  const float* __restrict__ o1, const float* __restrict__ g2,
                  const float* __restrict__ o2, float* __restrict__ out, int rows, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s32 = (float*)smem;                                               // M x LDS
  float* sa = (float*)(smem + lss::region<float>(M * LDS));                // M x LDA
  float* sh = (float*)((unsigned char*)sa + lss::region<float>(M * LDA));  // M x LDH
  float* sg = (float*)((unsigned char*)sh + lss::region<float>(M * LDH));  // M x LDG
  float* sw = (float*)((unsigned char*)sg + lss::region<float>(M * LDG));  // KC x LDW

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * M;
  constexpr int PER = C / 32;

  // 1. LN1, one warp per row.
  for (int r = warp; r < M; r += lss::kThreads / 32) {
    const int row = row0 + r;
    float x[PER];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      x[i] = row < rows ? u[(size_t)row * C + lane + 32 * i] : 0.f;
      sum += x[i];
    }
    const float mu = lss::warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) sq += (x[i] - mu) * (x[i] - mu);
    const float rs = rsqrtf(lss::warp_sum(sq) / C + eps);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      const float s = row < rows ? (x[i] - mu) * rs * g1[c] + o1[c] : 0.f;
      s32[r * LDS + c] = s;
      sa[r * LDA + c] = s;
    }
  }
  __syncthreads();

  // 2. y starts at s (the residual); hidden chunks accumulate into it.
  lss::TileMMA<M, C> y;
  y.load(s32, LDS);
  lss::TileMMA<M, FC> hacc;
  for (int k0 = 0; k0 < F; k0 += FC) {
    hacc.zero();
    for (int kc = 0; kc < C; kc += KC) {
      for (int e = tid; e < KC * FC; e += lss::kThreads) {
        const int rr = e / FC, cc = e % FC;
        sw[rr * LDW + cc] = w1[(size_t)(kc + rr) * F + k0 + cc];
      }
      __syncthreads();
      hacc.mma(sa + kc, LDA, sw, LDW, KC);
      __syncthreads();
    }
    hacc.store(sh, LDH);
    __syncthreads();
    for (int e = tid; e < M * FC; e += lss::kThreads) {
      const int rr = e / FC, cc = e % FC;
      sg[rr * LDG + cc] = gelu_erf(sh[rr * LDH + cc] + b1[k0 + cc]);
    }
    __syncthreads();
    for (int kc = 0; kc < FC; kc += KC) {
      for (int e = tid; e < KC * C; e += lss::kThreads) {
        const int rr = e / C, cc = e % C;
        sw[rr * LDW + cc] = w2[(size_t)(k0 + kc + rr) * C + cc];
      }
      __syncthreads();
      y.mma(sg + kc, LDG, sw, LDW, KC);
      __syncthreads();
    }
  }
  y.store(s32, LDS);
  __syncthreads();

  // 3. + b2, LN2, store.
  for (int r = warp; r < M; r += lss::kThreads / 32) {
    const int row = row0 + r;
    if (row >= rows) continue;
    float x[PER];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      x[i] = s32[r * LDS + c] + b2[c];
      sum += x[i];
    }
    const float mu = lss::warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) sq += (x[i] - mu) * (x[i] - mu);
    const float rs = rsqrtf(lss::warp_sum(sq) / C + eps);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      out[(size_t)row * C + c] = (x[i] - mu) * rs * g2[c] + o2[c];
    }
  }
}

// ---- bfloat16: warpgroup products fed by TMA -------------------------------
//
// A block of 384 threads owns ROWS = 128 rows. Warpgroups 0 and 1 compute,
// on rows 64g..64g+63 each; warpgroup 2 is the producer, one thread of which
// issues every copy (TMA) and which gives its registers to the other two.
// Shared memory holds the u tile, turned in place into LN1's output s in
// bf16 (64 KB, the A operand of product 1), and a 2-stage ring of weight
// chunks; stage = W1^T[chunk] (FC x 256) + W2^T[:, chunk] (256 x FC), 64 KB,
// each in wgmma's 128-byte-swizzled K-major layout, which the TMA writes.
// For each of the 16 hidden chunks a consumer runs wgmma h (64 x FC) = s
// W1[:, chunk] with A and B from shared memory, + b1 and GELU in registers,
// rounded to bf16 straight into the register A operand of wgmma y (64 x 256)
// += g W2[chunk, :]. The hidden activation never leaves registers; half of
// each GELU runs under the first half of product 2. The consumers meet the
// producer only at the ring's mbarriers. y starts at the float32 s + b2 (the
// residual, rebuilt from u and LN1's row statistics), so LN2 reads it
// straight from the accumulator.
namespace bf16k {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 128;                 // rows per block, 64 per consumer
constexpr int FC = 64;                    // hidden chunk
constexpr int NCHUNK = F / FC;            // 16
constexpr int S_KB = ROWS * 128;          // one 64-wide k-block of s (16 KB)
constexpr int S_BYTES = 4 * S_KB;         // s: 4 k-blocks of ROWS x 64
constexpr int W1_KB = FC * 128;           // one 64-wide k-block of a W1^T chunk
constexpr int W1_BYTES = 4 * W1_KB;       // FC x 256
constexpr int STAGE = W1_BYTES + C * 128;  // + W2^T chunk, 256 x FC
constexpr int STAGES = 2;
constexpr int STATS = S_BYTES + STAGES * STAGE;  // mu, rstd per row (float)
constexpr int BARS = STATS + 2 * ROWS * 4;       // mbarriers: u, full[2], empty[2]
constexpr size_t SMEM = BARS + 5 * 8 + 1024;     // + slack to align to 1024

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__global__ void __launch_bounds__(384, 1)
    ffn_ln_bf16_kernel(const __grid_constant__ CUtensorMap tm_u,
                       const __grid_constant__ CUtensorMap tm_w1t,
                       const __grid_constant__ CUtensorMap tm_w2t, const bf16* __restrict__ b1,
                       const bf16* __restrict__ b2, const bf16* __restrict__ g1,
                       const bf16* __restrict__ o1, const bf16* __restrict__ g2,
                       const bf16* __restrict__ o2, bf16* __restrict__ out, int rows, float eps) {
  using namespace lss;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned, as the swizzle needs; an offset from smem_raw keeps
  // the compiler's accesses in the shared window (32-bit addresses)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t stage0 = s_base + S_BYTES;
  const uint32_t bar_u = s_base + BARS, bar_full = bar_u + 8, bar_empty = bar_u + 24;
  float* stat = (float*)(smem + STATS);  // mu[ROWS], rstd[ROWS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = warp / 4;  // warpgroup
  const int row0 = blockIdx.x * ROWS;

  if (tid == 0) {
    mbar_init(bar_u, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (g == 2) {
    // ---- producer: the u tile (rows past the end arrive as zeros), then
    // the weight chunks, each into the stage both consumers have released.
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_expect_tx(bar_u, S_BYTES);
      for (int kb = 0; kb < 4; ++kb) tma_load_2d(s_base + kb * S_KB, &tm_u, bar_u, kb * 64, row0);
      for (int c = 0; c < NCHUNK; ++c) {
        const int st = c % STAGES;
        const uint32_t stage = stage0 + st * STAGE, full = bar_full + 8 * st;
        if (c >= STAGES) mbar_wait(bar_empty + 8 * st, ((c / STAGES) - 1) & 1);
        mbar_expect_tx(full, STAGE);
        for (int kb = 0; kb < 4; ++kb)
          tma_load_2d(stage + kb * W1_KB, &tm_w1t, full, kb * 64, c * FC);
        tma_load_2d(stage + W1_BYTES, &tm_w2t, full, c * FC, 0);
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<240>();
    const int bar_id = 1 + g;  // this warpgroup's named barrier
    mbar_wait(bar_u, 0);

    // 1. LN1's row statistics, a warp per row, 8 channels per lane.
    for (int r = g * 64 + warp % 4; r < g * 64 + 64; r += 4) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(smem + (lane / 8) * S_KB + sw128(r, lane % 8));
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
      float x[8], sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += (x[i] = __bfloat162float(xv[i]));
      const float mu = warp_sum(sum) / C;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sq += (x[i] - mu) * (x[i] - mu);
      const float rs = rsqrtf(warp_sum(sq) / C + eps);
      if (lane == 0) stat[r] = mu, stat[ROWS + r] = rs;
    }
    warpgroup_bar(bar_id);

    // 2. y = s + b2 in float32, in the accumulator layout: this thread holds
    // rows ra = l/4 and ra + 8 of its warp's 16 and columns 8j + 2(l%4) + {0,1}.
    const int ra = g * 64 + (warp % 4) * 16 + lane / 4;  // block row of y[4j], y[4j+1]
    const int cq = 2 * (lane % 4);
    float y[128];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + 8 * half;
      const float mu = stat[r], rs = stat[ROWS + r];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + cq;
        const float2 x = ld_bf2((const bf16*)(smem + (j / 8) * S_KB + sw128(r, j % 8) + cq * 2));
        const float2 gg = ld_bf2(g1 + col), oo = ld_bf2(o1 + col), bb = ld_bf2(b2 + col);
        y[4 * j + 2 * half] = (x.x - mu) * rs * gg.x + oo.x + bb.x;
        y[4 * j + 2 * half + 1] = (x.y - mu) * rs * gg.y + oo.y + bb.y;
      }
    }
    warpgroup_bar(bar_id);

    // 3. s = LN1(u) in bf16, in place: the A operand of product 1.
    {
      float gv[8], ov[8];
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        const float2 a = ld_bf2(g1 + lane * 8 + i), b = ld_bf2(o1 + lane * 8 + i);
        gv[i] = a.x, gv[i + 1] = a.y, ov[i] = b.x, ov[i + 1] = b.y;
      }
      for (int r = g * 64 + warp % 4; r < g * 64 + 64; r += 4) {
        uint4* p = reinterpret_cast<uint4*>(smem + (lane / 8) * S_KB + sw128(r, lane % 8));
        const uint4 raw = *p;
        const bf16* xv = reinterpret_cast<const bf16*>(&raw);
        const float mu = stat[r], rs = stat[ROWS + r];
        uint32_t pw[4];
#pragma unroll
        for (int i = 0; i < 8; i += 2)
          pw[i / 2] = pack_bf16((__bfloat162float(xv[i]) - mu) * rs * gv[i] + ov[i],
                                (__bfloat162float(xv[i + 1]) - mu) * rs * gv[i + 1] + ov[i + 1]);
        *p = make_uint4(pw[0], pw[1], pw[2], pw[3]);
      }
    }
    fence_proxy_async();
    warpgroup_bar(bar_id);

    // 4. The hidden chunks. Half of each GELU runs under the first half of
    // product 2.
    const uint32_t a_base = s_base + g * 64 * 128;  // this warpgroup's rows of s
    for (int c = 0; c < NCHUNK; ++c) {
      const int st = c % STAGES;
      const uint32_t stage = stage0 + st * STAGE;
      mbar_wait(bar_full + 8 * st, (c / STAGES) & 1);
      float h[32];
      fence_regs(h);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 16; ++ks)
        wgmma_ss_n64(h, desc_sw128(a_base + (ks / 4) * S_KB + (ks % 4) * 32),
                     desc_sw128(stage + (ks / 4) * W1_KB + (ks % 4) * 32), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(h);

      // + b1, GELU(erf), bf16: accumulator columns 16kk.. map onto k-step kk
      // of the A operand of product 2.
      uint32_t a[4][4];
#pragma unroll
      for (int part = 0; part < 2; ++part) {
#pragma unroll
        for (int kk = 2 * part; kk < 2 * part + 2; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 8 * kk + 2 * q;
            const float2 bb = ld_bf2(b1 + c * FC + 8 * (i / 4) + cq);
            a[kk][q] = pack_bf16(gelu_erf(h[i] + bb.x), gelu_erf(h[i + 1] + bb.y));
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 2 * part; kk < 2 * part + 2; ++kk)
          wgmma_rs_n256(y, a[kk], desc_sw128(stage + W1_BYTES + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // this warp is done with the stage
    }

    // 5. LN2 from the accumulator: a row's 256 values lie in the 4 lanes of a quad.
    float mu[2], rs[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sm = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) sm += y[4 * j + 2 * half] + y[4 * j + 2 * half + 1];
      sm += __shfl_xor_sync(0xffffffffu, sm, 1);
      sm += __shfl_xor_sync(0xffffffffu, sm, 2);
      mu[half] = sm / C;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float d0 = y[4 * j + 2 * half] - mu[half], d1 = y[4 * j + 2 * half + 1] - mu[half];
        q += d0 * d0 + d1 * d1;
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      rs[half] = rsqrtf(q / C + eps);
    }
    // Stage the bf16 rows in this warpgroup's own rows of s (its products
    // are done), then store them with 16-byte writes.
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + cq;
      const float2 gg = ld_bf2(g2 + col), oo = ld_bf2(o2 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = (y[4 * j + 2 * half] - mu[half]) * rs[half] * gg.x + oo.x;
        const float v1 = (y[4 * j + 2 * half + 1] - mu[half]) * rs[half] * gg.y + oo.y;
        *reinterpret_cast<uint32_t*>(smem + (j / 8) * S_KB + sw128(ra + 8 * half, j % 8) +
                                     cq * 2) = pack_bf16(v0, v1);
      }
    }
    warpgroup_bar(bar_id);
    for (int e = tid % 128; e < 64 * 32; e += 128) {
      const int r = g * 64 + e / 32, kc = e % 32;
      const int row = row0 + r;
      if (row < rows)
        *reinterpret_cast<uint4*>(out + (size_t)row * C + kc * 8) =
            *reinterpret_cast<const uint4*>(smem + (kc / 8) * S_KB + sw128(r, kc % 8));
    }
  }
}

}  // namespace bf16k

int launch_f32(const void* u, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* g1, const void* o1, const void* g2, const void* o2, void* out,
               int rows, float eps, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(ffn_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_F32);
  if (e != cudaSuccess) return (int)e;
  ffn_ln_kernel<<<(rows + M - 1) / M, lss::kThreads, SMEM_F32, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
      (const float*)g1, (const float*)o1, (const float*)g2, (const float*)o2, (float*)out, rows,
      eps);
  return (int)cudaGetLastError();
}

// w1t (F x C) and w2t (C x F) are W1 and W2 transposed (K-major operands).
int launch_bf16(const void* u, const void* w1t, const void* b1, const void* w2t, const void* b2,
                const void* g1, const void* o1, const void* g2, const void* o2, void* out,
                int rows, float eps, void* stream) {
  using bf16k::bf16;
  // row-major matrices, read in boxes of (rows x 64); u's rows past the end
  // read as zeros
  const cuuint64_t du[2] = {C, (cuuint64_t)rows}, d1[2] = {C, F}, d2[2] = {F, C};
  const cuuint32_t bu[2] = {64, bf16k::ROWS}, b1_[2] = {64, bf16k::FC}, b2_[2] = {64, C};
  CUtensorMap tm_u, tm_w1t, tm_w2t;
  cudaError_t e = lss::tensor_map(&tm_u, u, 2, du, bu);
  if (e == cudaSuccess) e = lss::tensor_map(&tm_w1t, w1t, 2, d1, b1_);
  if (e == cudaSuccess) e = lss::tensor_map(&tm_w2t, w2t, 2, d2, b2_);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bf16k::ffn_ln_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bf16k::SMEM);
  if (e != cudaSuccess) return (int)e;
  bf16k::ffn_ln_bf16_kernel<<<(rows + bf16k::ROWS - 1) / bf16k::ROWS, 384, bf16k::SMEM,
                              (cudaStream_t)stream>>>(
      tm_u, tm_w1t, tm_w2t, (const bf16*)b1, (const bf16*)b2, (const bf16*)g1, (const bf16*)o1,
      (const bf16*)g2, (const bf16*)o2, (bf16*)out, rows, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ffn_ln_f32(const void* u, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* g1, const void* o1, const void* g2,
                          const void* o2, void* out, int rows, float eps, void* stream) {
  return launch_f32(u, w1, b1, w2, b2, g1, o1, g2, o2, out, rows, eps, stream);
}

extern "C" int ffn_ln_bf16(const void* u, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* g1, const void* o1, const void* g2,
                           const void* o2, void* out, int rows, float eps, void* stream) {
  return launch_bf16(u, w1, b1, w2, b2, g1, o1, g2, o2, out, rows, eps, stream);
}
