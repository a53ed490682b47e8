// Fused lift + splat, backward: both gradients in one launch.
//
// The JAX package's backward of the TPU kernel `_kernel` of
// lss2_multimodal_nu_tpu/ops/lift_splat_pallas.py is XLA, not Pallas:
// `_fused_bwd` of lss2_multimodal_nu_tpu/ops/lift_splat.py. With g the
// cotangent (B, n_voxels, C) of the output, for every point p of batch b
// (depth 0 or not):
//
//   ddepth[b, p]       = <g[b, seg[b, p]], feat[b, fidx[b, p]]>   (float32)
//   dfeat[b, r]        = sum over p with fidx[b, p] = r of depth[b, p] * g[b, seg[b, p]]
//
// An invalid point carries depth 0 and seg 0, so it adds nothing to dfeat
// but still gets <g[b, 0], feat> in ddepth, as in JAX. A seg out of range
// stops the kernel with a trap.
//
// Bound on the H100: bytes. At train-v2's B=8 in bf16 the function must read
// the rows of g that points hit (about 3500 of its 320000, under 1 MB: the
// rest of g is never read), feat (2.2 MB), depth, seg and fidx (4.2 MB) and
// write dfeat (2.2 MB) and ddepth (1.4 MB): about 11 MB, 0.003 ms at
// 3.35 TB/s (`chip_smoke.py` counts the rows from its inputs). The kernel
// takes about ten times that: its work is one wave of 8448 lane groups,
// each walking its row's 41 points with a few gathers in flight, so L2's
// latency, not the bytes, sets its time. The design walks feature rows, not
// voxels: one lane group per feature row (b, r)
// (`lift_splat.cuh`) keeps that row in float32 registers and walks the row's
// points through a CSR over fidx (`lift_splat.cuh`; on the main path fidx is
// the frustum's constant map and the wrapper caches its CSR).
// For each point the group gathers g[b, seg] with 16-byte loads (only the
// rows of voxels that points hit, and neighbouring feature rows hit
// neighbouring voxels, so g's rows come mostly from L2), writes ddepth once
// from the group's shuffle-reduced dot product (each point has exactly one
// feature row, so no two groups write it), and accumulates depth * g in
// float32. dfeat is written once, in feat's dtype. No atomics, no zeroing
// and no cast pass: the result repeats bit for bit from run to run.
#include "lift_splat.cuh"

namespace {

using namespace lss::splat;
using lss::kThreads;

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    lift_splat_bwd_kernel(const T* __restrict__ feat, const float* __restrict__ depth,
                          const int* __restrict__ seg, const T* __restrict__ g,
                          const int* __restrict__ order, const int* __restrict__ ptr,
                          T* __restrict__ dfeat, float* __restrict__ ddepth, int r, int c,
                          int n_voxels, int rows, int bbits, Group grp) {
  using V = lss::Vec<T>;
  const int row = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) >> grp.glog);
  if (row >= rows) return;  // the whole group leaves together
  const int G = 1 << grp.glog;
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask = group_mask(grp.glog);
  const size_t row_bytes = (size_t)c * sizeof(T);
  const int b = row / r, key = ((row - b * r) << bbits) | b;
  const char* gb = reinterpret_cast<const char*>(g) + (size_t)b * n_voxels * row_bytes;
  const char* src = reinterpret_cast<const char*>(feat) + (size_t)row * row_bytes;
  float fv[K][V::N], acc[K][V::N];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = lane + j * G;
    V::unpack(s < grp.slices ? lss::ld16(src + s * 16) : make_uint4(0u, 0u, 0u, 0u), fv[j]);
#pragma unroll
    for (int e = 0; e < V::N; ++e) acc[j][e] = 0.f;
  }

  const int k1 = ptr[key + 1];
  for (int k0 = ptr[key]; k0 < k1; k0 += G) {
    const int n = min(G, k1 - k0);
    // lane t loads the metadata of the run's point k0 + t
    float d = 0.f;
    int sg = 0, pt = 0;
    if (lane < n) {
      pt = order[k0 + lane];
      d = depth[pt];
      sg = seg[pt];
      if ((unsigned)sg >= (unsigned)n_voxels) __trap();
    }
    for (int t0 = 0; t0 < n; t0 += kInFlight) {
      uint4 raw[kInFlight][K];
      float dt[kInFlight];
      int it[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int t = t0 + u;
        dt[u] = __shfl_sync(mask, d, t & (G - 1), G);
        it[u] = __shfl_sync(mask, pt, t & (G - 1), G);
        const int st = __shfl_sync(mask, sg, t & (G - 1), G);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int s = lane + j * G;
          raw[u][j] = t < n && s < grp.slices ? lss::ld16(gb + (size_t)st * row_bytes + s * 16)
                                              : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (t0 + u >= n) continue;  // the same for every lane of the group
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float x[V::N];
          V::unpack(raw[u][j], x);
#pragma unroll
          for (int e = 0; e < V::N; ++e) {
            dot = fmaf(x[e], fv[j][e], dot);
            acc[j][e] = fmaf(dt[u], x[e], acc[j][e]);
          }
        }
        dot = group_sum(dot, mask, grp.glog);
        if (lane == 0) ddepth[it[u]] = dot;
      }
    }
  }
  char* dst = reinterpret_cast<char*>(dfeat) + (size_t)row * row_bytes;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = lane + j * G;
    if (s < grp.slices) *reinterpret_cast<uint4*>(dst + s * 16) = V::pack(acc[j]);
  }
}

template <typename T>
int launch(const void* feat, const void* depth, const void* seg, const void* g,
           const void* order, const void* ptr, void* dfeat, void* ddepth, int b, int r, int c,
           int n_voxels, void* stream) {
  Group grp;
  if (!group_for<T>(c, &grp)) return (int)cudaErrorInvalidValue;
  const int rows = b * r;
  const long long threads = (long long)rows << grp.glog;
  if (threads == 0) return 0;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  const int k = per_lane(grp);
  auto kernel = k == 1 ? lift_splat_bwd_kernel<T, 1>
                       : (k == 2 ? lift_splat_bwd_kernel<T, 2> : lift_splat_bwd_kernel<T, 4>);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)feat, (const float*)depth, (const int*)seg, (const T*)g,
      (const int*)order, (const int*)ptr, (T*)dfeat, (float*)ddepth, r, c, n_voxels,
      rows, bits_for(b - 1), grp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lift_splat_backward_f32(const void* feat, const void* depth, const void* seg,
                                       const void* g, const void* order, const void* ptr,
                                       void* dfeat, void* ddepth, int b, int r, int c,
                                       int n_voxels, void* stream) {
  return launch<float>(feat, depth, seg, g, order, ptr, dfeat, ddepth, b, r, c, n_voxels,
                       stream);
}

extern "C" int lift_splat_backward_bf16(const void* feat, const void* depth, const void* seg,
                                        const void* g, const void* order, const void* ptr,
                                        void* dfeat, void* ddepth, int b, int r, int c,
                                        int n_voxels, void* stream) {
  return launch<__nv_bfloat16>(feat, depth, seg, g, order, ptr, dfeat, ddepth, b, r, c,
                               n_voxels, stream);
}
