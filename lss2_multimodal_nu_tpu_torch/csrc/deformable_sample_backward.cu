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
// gradients once; but the corner gathers and the scatter-adds into dv (10.5
// GB of float32 at B=8) land in L2. The design is the forward's
// (`deformable.cuh`): a few lanes a query, each owning a 16-byte slice of
// the channels, a block's queries a 2-D tile of the query grid, (batch,
// head) the slowest grid index, so that the value map and its float32
// gradient (2.56 + 5.12 MB at 200x200x32 in bf16) stay in L2.
//  - g's slice is loaded once per query and kept in registers for every
//    point; each corner of v is one 16-byte load per lane.
//  - rc_k is the lane's partial dot over its channels, summed by __shfl_xor
//    inside the query's lane group (2 steps in bf16 at dh = 32); the group's
//    lanes share the writes of dlx, dly and dattn, so no rc tensor reaches
//    HBM.
//  - dv is summed with 16-byte float32 reductions (atomicAdd on a float4, a
//    vector RED at L2), 4 floats an operation where a scalar atomic adds
//    one. Neighbouring queries hit the same corners, so the order of the sum,
//    and dv's last bits, vary from run to run.
// The TPU's VMEM gradient table, RMW stripes, hi/lo selector products and
// quadrant-replicated cotangent have no counterpart here.
#include "deformable.cuh"

namespace {

using namespace lss::deform;

__device__ __forceinline__ void red4(float* p, float a, float b, float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

template <typename T, int NPTS>
__global__ void __launch_bounds__(lss::kThreads)
    deform_sample_bwd_kernel(const T* __restrict__ v, const float* __restrict__ lx,
                             const float* __restrict__ ly, const float* __restrict__ attn,
                             const T* __restrict__ g, float* __restrict__ dv,
                             float* __restrict__ dlx, float* __restrict__ dly,
                             float* __restrict__ dattn, Layout l, int npts, int n, int h, int w,
                             int dh) {
  using V = Vec<T>;
  // points whose lx/ly/attn are loaded together, kInFlight of them: all 8 of
  // the main path at once took 42 more registers and 2.4% more time
  constexpr int P = kInFlight;
  // No early return: the lanes of a query group exchange their partial sums,
  // and a lane without a query (or a slice) adds zeros.
  const Lane me = lane_of(l, n, w);
  const int G = 1 << l.glog;
  const int np = NPTS > 0 ? NPTS : npts;
  const int bh = blockIdx.y;
  const size_t row_bytes = (size_t)dh * sizeof(T);
  const size_t map = (size_t)bh * h * w;
  const char* vb = reinterpret_cast<const char*>(v) + map * row_bytes;
  float* dvb = dv + map * dh;
  const char* gq = reinterpret_cast<const char*>(g) + ((size_t)bh * n + me.q) * row_bytes;
  const size_t first = (size_t)bh * np * n + me.q;  // index of point 0 in lx, ly, attn

  // the lane's first slice of g, kept for every point; a row of more than
  // 32 slices reloads the others (from L1) at each point
  float g0[V::N];
  if (me.live && me.j < l.slices)
    V::unpack(ld16(gq + me.j * 16), g0);
  else
#pragma unroll
    for (int e = 0; e < V::N; ++e) g0[e] = 0.f;

  // The dv reductions of the first slices. L2 sums a reduction per 32-byte
  // sector, and in bf16 a lane's slice is 8 floats of dv, a whole sector that
  // two 16-byte reductions would each half fill, at twice the sector
  // operations. So the group's lanes trade g values once: reduction r of
  // lane j covers floats 4 (r G + j) .. +3 of the row, and a group's
  // reduction instruction fills whole sectors. In float32 a lane's 4 floats
  // already lie next to its neighbours'.
  constexpr int R = V::N / 4;  // 16-byte reductions a lane makes per corner
  float gr[V::N];
  int fr[R];  // float offset in the dv row of reduction r, -1 past dh
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int f = 4 * (r * G + me.j);
    fr[r] = f < dh ? f : -1;
    const int src = (threadIdx.x & 31 & ~(G - 1)) + ((f / V::N) & (G - 1));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (R == 1) {
        gr[e] = g0[e];
        continue;
      }
      const float lo = __shfl_sync(0xffffffffu, g0[e], src);
      const float hi = __shfl_sync(0xffffffffu, g0[4 + e], src);
      gr[4 * r + e] = f % V::N ? hi : lo;
    }
  }

  // one sample's four corners on slice s: rc_k partial dots (when the lane
  // has slice s) and dv reductions
  auto slice = [&](int s, const float* gf, const Sample& sm, bool alive, float a, float* rc) {
    const bool own = alive && s < l.slices;
    const char* vs = vb + s * 16;
    uint4 cv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      cv[c] = own && sm.in[c] ? ld16(vs + (size_t)corner_row(sm, c, w) * row_bytes)
                              : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float f[V::N];
      V::unpack(cv[c], f);
#pragma unroll
      for (int e = 0; e < V::N; ++e) rc[c] = fmaf(f[e], gf[e], rc[c]);
      if (!alive || !sm.in[c]) continue;
      const float aw = a * corner_weight(sm, c);
      float* d = dvb + (size_t)corner_row(sm, c, w) * dh;
      if (s == me.j) {  // the first slices: the traded values, whole sectors
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (fr[r] >= 0)
            red4(d + fr[r], aw * gr[4 * r], aw * gr[4 * r + 1], aw * gr[4 * r + 2],
                 aw * gr[4 * r + 3]);
      } else {  // a row of more than 32 slices: the lane's own slice
#pragma unroll
        for (int e = 0; e < V::N; e += 4)
          red4(d + s * V::N + e, aw * gf[e], aw * gf[e + 1], aw * gf[e + 2], aw * gf[e + 3]);
      }
    }
  };

  for (int p0 = 0; p0 < np; p0 += P) {
    float x[P], y[P], a[P];
    bool alive[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      alive[k] = me.live && (NPTS > 0 || p0 + k < np);
      const size_t i = first + (size_t)(p0 + k) * n;
      x[k] = alive[k] ? lx[i] : 0.f;
      y[k] = alive[k] ? ly[i] : 0.f;
      a[k] = alive[k] ? attn[i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const Sample sm = sample(x[k], y[k], h, w);
      float rc[4] = {0.f, 0.f, 0.f, 0.f};
      slice(me.j, g0, sm, alive[k], a[k], rc);
      for (int s = me.j + G; s < l.slices; s += G) {
        float gf[V::N];
        V::unpack(ld16(gq + s * 16), gf);
        slice(s, gf, sm, alive[k], a[k], rc);
      }
      // rc over the query's lanes: every lane of the group ends with the sums
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        if (o >= G) break;
#pragma unroll
        for (int c = 0; c < 4; ++c) rc[c] += __shfl_xor_sync(0xffffffffu, rc[c], o);
      }
      if (!alive[k]) continue;
      // the three small gradients, shared out over the group's lanes
      const float wx = sm.wx, wy = sm.wy;
      const size_t i = first + (size_t)(p0 + k) * n;
      if (me.j == 0)
        dattn[i] = corner_weight(sm, 0) * rc[0] + corner_weight(sm, 1) * rc[1] +
                   corner_weight(sm, 2) * rc[2] + corner_weight(sm, 3) * rc[3];
      if (me.j == (1 & (G - 1)))
        dlx[i] = w * a[k] * ((1.f - wy) * (rc[1] - rc[0]) + wy * (rc[3] - rc[2]));
      if (me.j == (2 & (G - 1)))
        dly[i] = h * a[k] * ((1.f - wx) * (rc[2] - rc[0]) + wx * (rc[3] - rc[1]));
    }
  }
}

template <typename T>
int launch(const void* v, const void* lx, const void* ly, const void* attn, const void* g,
           void* dv, void* dlx, void* dly, void* dattn, int bh, int npts, int n, int h, int w,
           int dh, void* stream) {
  if (dh % 8 != 0 || npts < 1 || n < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const Layout l = layout<T>(n, w, dh);
  const dim3 grid(l.tiles, bh);
  const auto kernel = npts == 8 ? deform_sample_bwd_kernel<T, 8> : deform_sample_bwd_kernel<T, 0>;
  kernel<<<grid, lss::kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)v, (const float*)lx, (const float*)ly, (const float*)attn, (const T*)g,
      (float*)dv, (float*)dlx, (float*)dly, (float*)dattn, l, npts, n, h, w, dh);
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
