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
// 1024) the two products are 252 GFLOP against 246 MB of rows in and out
// (float32: 492 MB), so the tensor cores set the floor: 0.25 ms at the bf16
// peak, 1.53 ms for float32 as three TF32 passes at the TF32 peak (3.76 ms
// at the SIMT float32 peak, the first port's design). Both instantiations
// keep the 1024-wide hidden activation on chip, which is what the fusion is
// for.
//
// bfloat16 (`bf16k`): warpgroup products (wgmma) fed by TMA. A
// producer warpgroup loads each block's 128-row u tile and streams the
// weights through a 2-stage ring in wgmma's swizzled layout, with mbarriers;
// two consumer warpgroups of 64 rows each run product 1 from shared memory,
// GELU in registers, and product 2 with the GELU output as the register A
// operand, and LN2 on the accumulator. What holds it back now is the GELU:
// erff for 246 M hidden values costs about a third of the kernel's time and
// runs while the tensor cores wait, as both consumers reach it together.
//
// float (`tf32k`): the same warpgroups on TF32 wgmma in three passes
// (hopper.cuh), so that the result is as close as float32 products: the
// weights are split into hi and lo once per call by a small kernel, the
// activations in registers. What bounds its design is shared memory (see
// the note there).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int C = 256;    // model width
constexpr int F = 1024;   // hidden width

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
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

// ---- float: TF32 warpgroup products in three passes, fed by TMA ------------
//
// The bf16 design with float operands. What changes is shared memory: hi and
// lo weight tiles take four times bf16's bytes per hidden column (a 64-wide
// W1^T + W2^T chunk would be 256 KB), and a float s tile takes twice. So:
//  - s stays in shared memory once, in float32 (128 rows, 128 KB, LN1 in
//    place), and product 1 reads it as the register A operand: ldmatrix per
//    k-step, split into hi and lo in registers. Keeping s as hi and lo tiles
//    for a shared-memory A would need 256 KB; 64-row blocks would need 128
//    KB for s and double the weights' L2 traffic (4 MB of hi/lo weights per
//    block: 7.5 GB a flagship call at 128 rows).
//  - the weights stream as 16 KB items, each a 64 x 32 tile of hi then lo,
//    through a 6-stage ring: for each 64-wide hidden chunk, 8 items of
//    W1^T[chunk, k-block] (product 1) and 8 of W2^T[64 outputs, 32 hidden]
//    (product 2). Every wgmma is m64n64k8, none narrower.
// The consumers keep one group of products in flight while they load and
// split the next group's A (two k-steps, 16 registers), and take product 2
// in two halves of 32 hidden columns, so that y (128 floats), h (32) and the
// A registers fit in 240 without spilling. Product 2's A is the
// GELU output straight from h's accumulator: the accumulator holds columns
// (2t, 2t+1) of each group of 8, the TF32 A fragment wants (t, t + 4), so
// W2^T's K axis is permuted by 0 2 4 6 1 3 5 7 in each group of 8 when it is
// split, and A = {d0, d2, d1, d3}. GELU runs in float32 on the unsplit
// value. y starts at s + b2 read from the float tile.
namespace tf32k {

constexpr int ROWS = 128;                 // rows per block, 64 per consumer
constexpr int FC = 64;                    // hidden chunk
constexpr int NCHUNK = F / FC;            // 16
constexpr int S_KB = ROWS * 128;          // one 32-wide k-block of s (16 KB)
constexpr int S_BYTES = (C / 32) * S_KB;  // s: 8 k-blocks of ROWS x 32 floats
constexpr int HALF = 64 * 128;            // a 64 x 32 float tile (8 KB)
constexpr int ITEM = 2 * HALF;            // hi, then lo
constexpr int P1_ITEMS = C / 32;          // W1^T[chunk, k-block kb]
constexpr int ITEMS = 2 * P1_ITEMS;       // + W2^T[64 outputs n, 32 hidden kh]: (kh, n)
constexpr int STAGES = 6;
constexpr int BARS = S_BYTES + STAGES * ITEM;  // mbarriers: u, full[STAGES], empty[STAGES]
constexpr size_t SMEM = BARS + (1 + 2 * STAGES) * 8 + 1024;  // + slack to align to 1024
static_assert(SMEM <= 232448, "over the H100's 227 KB of shared memory a block");

// Consumer side of ring item i: wait until it has arrived; its tiles.
__device__ __forceinline__ uint32_t acquire(int i, uint32_t ring, uint32_t full) {
  lss::mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
  return ring + (i % STAGES) * ITEM;
}

__global__ void __launch_bounds__(384, 1)
    ffn_ln_tf32_kernel(const __grid_constant__ CUtensorMap tm_u,
                       const __grid_constant__ CUtensorMap tm_w1s,
                       const __grid_constant__ CUtensorMap tm_w2s, const float* __restrict__ b1,
                       const float* __restrict__ b2, const float* __restrict__ g1,
                       const float* __restrict__ o1, const float* __restrict__ g2,
                       const float* __restrict__ o2, float* __restrict__ out, int rows, float eps) {
  using namespace lss;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t ring = s_base + S_BYTES;
  const uint32_t bar_u = s_base + BARS, bar_full = bar_u + 8, bar_empty = bar_full + 8 * STAGES;

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
    // ---- producer: the u tile (rows past the end arrive as zeros), then the
    // items in the order the consumers take them. w1s is (2F, C): W1^T hi
    // over lo; w2s is (2C, F): W2^T hi over lo, K permuted.
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_expect_tx(bar_u, S_BYTES);
      for (int kb = 0; kb < C / 32; ++kb) tma_load_2d(s_base + kb * S_KB, &tm_u, bar_u, kb * 32, row0);
      // chunk c's items: 8 of W1^T (x = k-block, y = chunk), then 8 of W2^T
      // (x = chunk's hidden half kh, y = outputs n)
      for (int i = 0; i < NCHUNK * ITEMS; ++i) {
        const int c = i / ITEMS, j = i % ITEMS, st = i % STAGES;
        const bool p1 = j < P1_ITEMS;
        const CUtensorMap* tm = p1 ? &tm_w1s : &tm_w2s;
        const int x = p1 ? j * 32 : c * FC + ((j - P1_ITEMS) / 4) * 32;
        const int y = p1 ? c * FC : ((j - P1_ITEMS) % 4) * 64;
        const uint32_t dst = ring + st * ITEM, full = bar_full + 8 * st;
        if (i >= STAGES) mbar_wait(bar_empty + 8 * st, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full, ITEM);
        tma_load_2d(dst, tm, full, x, y);
        tma_load_2d(dst + HALF, tm, full, x, y + (p1 ? F : C));
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<240>();
    const int bar_id = 1 + g;  // this warpgroup's named barrier
    mbar_wait(bar_u, 0);

    // 1. s = LN1(u) in float32, in place; a warp per row, lane l holding the
    // 8 columns 32 (l/4) + 8 (l%4) + 0..7 (two 16-byte chunks of k-block l/4).
    {
      const int c0 = 32 * (lane / 4) + 8 * (lane % 4);
      float gv[8], ov[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) gv[i] = g1[c0 + i], ov[i] = o1[c0 + i];
      for (int r = g * 64 + warp % 4; r < g * 64 + 64; r += 4) {
        float4* p0 = reinterpret_cast<float4*>(smem + (lane / 4) * S_KB + sw128(r, 2 * (lane % 4)));
        float4* p1 = reinterpret_cast<float4*>(smem + (lane / 4) * S_KB + sw128(r, 2 * (lane % 4) + 1));
        const float4 a = *p0, b = *p1;
        float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += x[i];
        const float mu = warp_sum(sum) / C;
        float sq = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) sq += (x[i] - mu) * (x[i] - mu);
        const float rs = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = (x[i] - mu) * rs * gv[i] + ov[i];
        *p0 = make_float4(x[0], x[1], x[2], x[3]);
        *p1 = make_float4(x[4], x[5], x[6], x[7]);
      }
    }
    warpgroup_bar(bar_id);

    // 2. y = s + b2, in the accumulator layout of four n64 blocks: y[n][i]
    // at row ra + 8 ((i/2)%2), column 64n + 8 (i/4) + cq + i%2.
    const int ra = g * 64 + (warp % 4) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    float y[4][32];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * n + 8 * j + cq;
        const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 sv = *reinterpret_cast<const float2*>(
              smem + (2 * n + j / 4) * S_KB + sw128(ra + 8 * half, 2 * (j % 4) + cq / 4) + (cq % 4) * 4);
          y[n][4 * j + 2 * half] = sv.x + bb.x;
          y[n][4 * j + 2 * half + 1] = sv.y + bb.y;
        }
      }

    // 3. The hidden chunks. ldmatrix rows of this lane for product 1's A.
    const int arow = g * 64 + (warp % 4) * 16 + lane % 16;
    int it = 0;  // ring item
    for (int c = 0; c < NCHUNK; ++c) {
      // product 1: h (64 x FC) = s W1[:, chunk], a group of two k-steps in
      // flight while the next group's A is loaded and split.
      float h[32];
      uint32_t ahi[2][8], alo[2][8];
      fence_regs(h);
#pragma unroll 1
      for (int kb = 0; kb < P1_ITEMS; ++kb, ++it) {
        const uint32_t wb = acquire(it, ring, bar_full);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            uint32_t raw[4];
            ldmatrix_x4(raw, s_base + kb * S_KB + sw128(arow, 2 * (2 * half + q) + lane / 16));
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(raw[e], ahi[half][4 * q + e], alo[half][4 * q + e]);
          }
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int ks = 2 * half + q;
            wgmma_tf32x3<64>(h, &ahi[half][4 * q], &alo[half][4 * q], desc_sw128(wb + ks * 32),
                             desc_sw128(wb + HALF + ks * 32), (kb | half | q) != 0);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the group before this one is done
          fence_regs(ahi[1 - half]);
          fence_regs(alo[1 - half]);
          if (half == 0 && kb > 0 && lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
        }
      }
      wgmma_wait<0>();
      fence_regs(h);
      fence_regs(ahi[1]);
      fence_regs(alo[1]);
      if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));

      // product 2: y += g W2[chunk, :] in two halves of 32 hidden columns,
      // item (kh, n): hidden 32kh.., outputs 64n... g = GELU(h + b1) in
      // float32, split: k-step kk is columns 8kk.. of h, and its A is {d0, d2,
      // d1, d3} against W2^T's permuted K.
#pragma unroll
      for (int kh = 0; kh < FC / 32; ++kh) {
        uint32_t ghi[4][4], glo[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * kh + q;
          const float2 bb = *reinterpret_cast<const float2*>(b1 + c * FC + 8 * kk + cq);
          const uint32_t v[4] = {__float_as_uint(gelu_erf(h[4 * kk] + bb.x)),
                                 __float_as_uint(gelu_erf(h[4 * kk + 2] + bb.x)),
                                 __float_as_uint(gelu_erf(h[4 * kk + 1] + bb.y)),
                                 __float_as_uint(gelu_erf(h[4 * kk + 3] + bb.y))};
          split_tf32(v, ghi[q], glo[q]);
        }
#pragma unroll
        for (int n = 0; n < C / 64; ++n, ++it) {
          const uint32_t wb = acquire(it, ring, bar_full);
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wgmma_tf32x3<64>(y[n], ghi[q], glo[q], desc_sw128(wb + q * 32),
                             desc_sw128(wb + HALF + q * 32));
          wgmma_commit();
          wgmma_wait<1>();
          if (n > 0 && lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
        }
        // this half's A registers are rewritten next: wait its products out
        wgmma_wait<0>();
#pragma unroll
        for (int n = 0; n < 4; ++n) fence_regs(y[n]);
#pragma unroll
        for (int q = 0; q < 4; ++q) fence_regs(ghi[q]), fence_regs(glo[q]);
        if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
      }
    }

    // 4. LN2 from the accumulator: a row's 256 values lie in the 4 lanes of a quad.
    float mu[2], rs[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sm = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) sm += y[n][4 * j + 2 * half] + y[n][4 * j + 2 * half + 1];
      sm += __shfl_xor_sync(0xffffffffu, sm, 1);
      sm += __shfl_xor_sync(0xffffffffu, sm, 2);
      mu[half] = sm / C;
      float q = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d0 = y[n][4 * j + 2 * half] - mu[half], d1 = y[n][4 * j + 2 * half + 1] - mu[half];
          q += d0 * d0 + d1 * d1;
        }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      rs[half] = rsqrtf(q / C + eps);
    }
    // Stage the rows in this warpgroup's own rows of s (only it reads them),
    // then store them with 16-byte writes.
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * n + 8 * j + cq;
        const float2 gg = *reinterpret_cast<const float2*>(g2 + col);
        const float2 oo = *reinterpret_cast<const float2*>(o2 + col);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(smem + (2 * n + j / 4) * S_KB +
                                     sw128(ra + 8 * half, 2 * (j % 4) + cq / 4) + (cq % 4) * 4) =
              make_float2((y[n][4 * j + 2 * half] - mu[half]) * rs[half] * gg.x + oo.x,
                          (y[n][4 * j + 2 * half + 1] - mu[half]) * rs[half] * gg.y + oo.y);
      }
    warpgroup_bar(bar_id);
    for (int e = tid % 128; e < 64 * 64; e += 128) {
      const int r = g * 64 + e / 64, kc = e % 64;
      const int row = row0 + r;
      if (row < rows)
        *reinterpret_cast<float4*>(out + (size_t)row * C + kc * 4) =
            *reinterpret_cast<const float4*>(smem + (kc / 8) * S_KB + sw128(r, kc % 8));
    }
  }
}

}  // namespace tf32k

// The weights' hi/lo split (one launch for both): w1 (C, F) -> w1s (2, F, C),
// W1^T's hi over its lo; w2 (F, C) -> w2s (2, C, F), W2^T's with K permuted.
int split_f32(const void* w1, const void* w2, void* w1s, void* w2s, void* stream) {
  float* a = (float*)w1s;
  float* b = (float*)w2s;
  return (int)lss::split_weights(lss::SplitJob{(const float*)w1, a, a + F * C, 1, C, F, 0},
                                 lss::SplitJob{(const float*)w2, b, b + C * F, 1, F, C, 1},
                                 (cudaStream_t)stream);
}

// u (rows, C), biases and norm parameters float; w1s, w2s the split of
// split_f32, filled here first.
int launch_f32(const void* u, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* g1, const void* o1, const void* g2, const void* o2, void* w1s,
               void* w2s, void* out, int rows, float eps, void* stream) {
  int code = split_f32(w1, w2, w1s, w2s, stream);
  if (code != 0) return code;
  constexpr auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t du[2] = {C, (cuuint64_t)rows}, d1[2] = {C, 2 * F}, d2[2] = {F, 2 * C};
  const cuuint32_t bu[2] = {32, tf32k::ROWS}, bw[2] = {32, 64};
  CUtensorMap tm_u, tm_w1s, tm_w2s;
  cudaError_t e = lss::tensor_map(&tm_u, u, 2, du, bu, f32);
  if (e == cudaSuccess) e = lss::tensor_map(&tm_w1s, w1s, 2, d1, bw, f32);
  if (e == cudaSuccess) e = lss::tensor_map(&tm_w2s, w2s, 2, d2, bw, f32);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tf32k::ffn_ln_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tf32k::SMEM);
  if (e != cudaSuccess) return (int)e;
  tf32k::ffn_ln_tf32_kernel<<<(rows + tf32k::ROWS - 1) / tf32k::ROWS, 384, tf32k::SMEM,
                              (cudaStream_t)stream>>>(
      tm_u, tm_w1s, tm_w2s, (const float*)b1, (const float*)b2, (const float*)g1,
      (const float*)o1, (const float*)g2, (const float*)o2, (float*)out, rows, eps);
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

// float32: w1 (C, F), w2 (F, C) as given; w1s (2, F, C) and w2s (2, C, F) are
// scratch for their split.
extern "C" int ffn_ln_f32(const void* u, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* g1, const void* o1, const void* g2,
                          const void* o2, void* w1s, void* w2s, void* out, int rows, float eps,
                          void* stream) {
  return launch_f32(u, w1, b1, w2, b2, g1, o1, g2, o2, w1s, w2s, out, rows, eps, stream);
}

// The split alone, for the tests.
extern "C" int ffn_ln_split_f32(const void* w1, const void* w2, void* w1s, void* w2s,
                                void* stream) {
  return split_f32(w1, w2, w1s, w2s, stream);
}

extern "C" int ffn_ln_bf16(const void* u, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* g1, const void* o1, const void* g2,
                           const void* o2, void* out, int rows, float eps, void* stream) {
  return launch_bf16(u, w1, b1, w2, b2, g1, o1, g2, o2, out, rows, eps, stream);
}
