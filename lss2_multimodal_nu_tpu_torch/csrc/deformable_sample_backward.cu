// Deformable-attention sampling, backward.
//
// Replaces the TPU kernel `_bwd_kernel` of lss2_multimodal_nu_tpu/ops/
// deformable_pallas.py (reached through `_sample_pallas_bwd`) together with
// the dense math that `_bwd_pallas` runs on its output.
//
// With the forward's geometry, for each (bh, point p, query q):
//   fx = lx*w - 0.5, x0 = floor(fx), wx = fx - x0 (and the same for y);
//   corner k = (dy, dx) in {00, 01, 10, 11} reads zero outside the map;
//   rc_k = sum_d v[bh, corner_k, d] * g[bh, q, d];
//   dv[bh, corner_k, :] += attn * wt_k * g[bh, q, :]     (float32 buffer)
//   dattn = sum_k wt_k * rc_k
//   dlx   = w * attn * ((1-wy)(rc_01 - rc_00) + wy(rc_11 - rc_10))
//   dly   = h * attn * ((1-wx)(rc_10 - rc_00) + wx(rc_11 - rc_01))
//
// Bound on the H100: memory, as the forward. The bytes that must cross HBM
// are v and g once, lx/ly/attn once, the float32 dv once and the three small
// gradients once. The design is the forward's: one warp per query, one lane
// per channel, a block's queries inside one (batch, head) (blockIdx.y) so
// that the value map and its float32 gradient (2.56 + 5.12 MB at 200x200x32
// in bf16) stay in L2, where the corner gathers and the scatter-adds land.
// rc_k is a warp-shuffle sum; lane 0 writes the three small gradients, so no
// rc tensor reaches HBM. dv is summed with float32 atomics (RED, the result
// is unused): neighbouring queries hit the same corners, so the order of the
// sum, and dv's last bits, vary from run to run. The TPU's VMEM gradient
// table, RMW stripes, hi/lo selector products and quadrant-replicated
// cotangent have no counterpart here.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    deform_sample_bwd_kernel(const T* __restrict__ v, const float* __restrict__ lx,
                             const float* __restrict__ ly, const float* __restrict__ attn,
                             const T* __restrict__ g, float* __restrict__ dv,
                             float* __restrict__ dlx, float* __restrict__ dly,
                             float* __restrict__ dattn, int npts, int n, int h, int w, int dh) {
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * kWarps + threadIdx.x / 32;
  const int bh = blockIdx.y;
  if (q >= n) return;  // uniform over the warp
  const size_t map = (size_t)bh * h * w * dh;
  const T* vb = v + map;
  float* dvb = dv + map;
  const T* gq = g + ((size_t)bh * n + q) * dh;
  for (int p = 0; p < npts; ++p) {
    const size_t i = ((size_t)bh * npts + p) * n + q;
    const float a = attn[i];
    const float fx = lx[i] * w - 0.5f;
    const float fy = ly[i] * h - 0.5f;
    const float x0f = floorf(fx), y0f = floorf(fy);
    const float wx = fx - x0f, wy = fy - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    float wt[4];
    int row[4];  // -1 outside the map
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int yy = y0 + (k >> 1), xx = x0 + (k & 1);
      wt[k] = ((k >> 1) ? wy : 1.f - wy) * ((k & 1) ? wx : 1.f - wx);
      row[k] = (yy >= 0 && yy < h && xx >= 0 && xx < w) ? yy * w + xx : -1;
    }
    float rc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = lane; c < dh; c += 32) {
      const float gc = lss::to_f(gq[c]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (row[k] < 0) continue;
        const size_t off = (size_t)row[k] * dh + c;
        rc[k] = fmaf(lss::to_f(vb[off]), gc, rc[k]);
        atomicAdd(dvb + off, a * wt[k] * gc);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) rc[k] = lss::warp_sum(rc[k]);
    if (lane == 0) {
      dattn[i] = wt[0] * rc[0] + wt[1] * rc[1] + wt[2] * rc[2] + wt[3] * rc[3];
      dlx[i] = w * a * ((1.f - wy) * (rc[1] - rc[0]) + wy * (rc[3] - rc[2]));
      dly[i] = h * a * ((1.f - wx) * (rc[2] - rc[0]) + wx * (rc[3] - rc[1]));
    }
  }
}

template <typename T>
int launch(const void* v, const void* lx, const void* ly, const void* attn, const void* g,
           void* dv, void* dlx, void* dly, void* dattn, int bh, int npts, int n, int h, int w,
           int dh, void* stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, bh);
  deform_sample_bwd_kernel<T><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)v, (const float*)lx, (const float*)ly, (const float*)attn, (const T*)g,
      (float*)dv, (float*)dlx, (float*)dly, (float*)dattn, npts, n, h, w, dh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int deform_sample_bwd_f32(const void* v, const void* lx, const void* ly,
                                     const void* attn, const void* g, void* dv, void* dlx,
                                     void* dly, void* dattn, int bh, int npts, int n, int h,
                                     int w, int dh, void* stream) {
  return launch<float>(v, lx, ly, attn, g, dv, dlx, dly, dattn, bh, npts, n, h, w, dh, stream);
}

extern "C" int deform_sample_bwd_bf16(const void* v, const void* lx, const void* ly,
                                      const void* attn, const void* g, void* dv, void* dlx,
                                      void* dly, void* dattn, int bh, int npts, int n, int h,
                                      int w, int dh, void* stream) {
  return launch<__nv_bfloat16>(v, lx, ly, attn, g, dv, dlx, dly, dattn, bh, npts, n, h, w, dh,
                               stream);
}
