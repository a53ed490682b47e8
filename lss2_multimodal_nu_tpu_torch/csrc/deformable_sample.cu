// Deformable-attention sampling, forward.
//
// Replaces the TPU kernel `_kernel` of lss2_multimodal_nu_tpu/ops/
// deformable_pallas.py (reached through `_sample_pallas` and
// `deformable_sample_combine_pallas_xy_prefold`).
//
//   out[bh, q, :] = sum_p attn[bh, p, q] * bilinear(v[bh], lx[bh, p, q], ly[bh, p, q])
//
// bilinear is grid_sample with align_corners=False and zero padding. v is
// channel-last (BH, H*W, dh), dh a multiple of 8; lx, ly, attn are float32.
//
// Bound on the H100: memory. The bytes that must cross HBM are v once,
// lx/ly/attn once and the output once, but each query gathers 4 corner rows
// per point from its value map, and at B=6 those gathers read 3.9 GB of 64-B
// rows from L2 and L1. The design serves them with as few and as wide
// requests as it can, all in flight at once (`deformable.cuh` maps lanes to
// queries and 16-byte slices):
//  - a few lanes a query, each corner one 16-byte ld.global.nc per lane, so a
//    corner row is one request of the query's lane group;
//  - the geometry once per (query, point) on each lane, not per channel;
//  - every point's lx/ly/attn loaded first (coalesced over the warp's
//    consecutive queries), then the corner gathers of kInFlight points
//    issued before the first FMA that needs them: the points are unrolled,
//    npts a template constant (8 on the main path) or, in the generic
//    kernel, steps of kInFlight points;
//  - a block's queries form a 2-D tile of the query grid, so that the main
//    path's neighbouring samples hit in L1, and (batch, head) is the slowest
//    grid index, so that the value maps in flight stay in L2;
//  - the float32 sum rounded once and written as one 16-byte store a lane.
// The TPU's VMEM patch table, SMEM index prefetch and prefold output have no
// counterpart here.
#include "deformable.cuh"

namespace {

using namespace lss::deform;

// At most 64 registers a thread, so that 4 blocks (32 warps) share an SM:
// more gathers in flight than a larger kInFlight at fewer warps gives.
template <typename T, int NPTS>
__global__ void __launch_bounds__(lss::kThreads, 4)
    deform_sample_kernel(const T* __restrict__ v, const float* __restrict__ lx,
                         const float* __restrict__ ly, const float* __restrict__ attn,
                         T* __restrict__ out, Layout l, int npts, int n, int h, int w, int dh) {
  using V = Vec<T>;
  // points whose lx/ly/attn are loaded together: all of them when npts is a
  // template constant, else steps of kInFlight
  constexpr int P = NPTS > 0 ? NPTS : kInFlight;
  static_assert(P % kInFlight == 0, "points come in steps of kInFlight");
  const Lane me = lane_of(l, n, w);
  if (!me.live) return;  // the forward has no exchange between lanes
  const int np = NPTS > 0 ? NPTS : npts;
  const int bh = blockIdx.y;
  const size_t row_bytes = (size_t)dh * sizeof(T);
  const char* vb = reinterpret_cast<const char*>(v) + (size_t)bh * h * w * row_bytes;
  const size_t first = (size_t)bh * np * n + me.q;  // index of point 0 in lx, ly, attn
  char* ob = reinterpret_cast<char*>(out) + ((size_t)bh * n + me.q) * row_bytes;

  for (int s = me.j; s < l.slices; s += 1 << l.glog) {
    const char* vs = vb + s * 16;
    float acc[V::N];
#pragma unroll
    for (int e = 0; e < V::N; ++e) acc[e] = 0.f;
    for (int p0 = 0; p0 < np; p0 += P) {
      float x[P], y[P], a[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const bool alive = NPTS > 0 || p0 + k < np;
        const size_t i = first + (size_t)(p0 + k) * n;
        x[k] = alive ? lx[i] : 0.f;
        y[k] = alive ? ly[i] : 0.f;
        a[k] = alive ? attn[i] : 0.f;
      }
#pragma unroll
      for (int k0 = 0; k0 < P; k0 += kInFlight) {
        uint4 cv[kInFlight][4];
        float wt[kInFlight][4];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          const bool alive = NPTS > 0 || p0 + k0 + k < np;
          const Sample sm = sample(x[k0 + k], y[k0 + k], h, w);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const bool use = alive && sm.in[c];
            wt[k][c] = use ? a[k0 + k] * corner_weight(sm, c) : 0.f;
            cv[k][c] = use ? ld16(vs + (size_t)corner_row(sm, c, w) * row_bytes)
                           : make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int k = 0; k < kInFlight; ++k)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float f[V::N];
            V::unpack(cv[k][c], f);
#pragma unroll
            for (int e = 0; e < V::N; ++e) acc[e] = fmaf(wt[k][c], f[e], acc[e]);
          }
      }
    }
    *reinterpret_cast<uint4*>(ob + s * 16) = V::pack(acc);
  }
}

template <typename T>
int launch(const void* v, const void* lx, const void* ly, const void* attn, void* out, int bh,
           int npts, int n, int h, int w, int dh, void* stream) {
  if (dh % 8 != 0 || npts < 1 || n < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const Layout l = layout<T>(n, w, dh);
  const dim3 grid(l.tiles, bh);
  const auto kernel = npts == 8 ? deform_sample_kernel<T, 8> : deform_sample_kernel<T, 0>;
  kernel<<<grid, lss::kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)v, (const float*)lx, (const float*)ly, (const float*)attn, (T*)out, l, npts, n,
      h, w, dh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int deform_sample_f32(const void* v, const void* lx, const void* ly, const void* attn,
                                 void* out, int bh, int npts, int n, int h, int w, int dh,
                                 void* stream) {
  return launch<float>(v, lx, ly, attn, out, bh, npts, n, h, w, dh, stream);
}

extern "C" int deform_sample_bf16(const void* v, const void* lx, const void* ly,
                                  const void* attn, void* out, int bh, int npts, int n, int h,
                                  int w, int dh, void* stream) {
  return launch<__nv_bfloat16>(v, lx, ly, attn, out, bh, npts, n, h, w, dh, stream);
}
