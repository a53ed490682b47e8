// Fused lift + splat (voxel pooling), forward, and the index preparation
// that both lift-splat kernels share.
//
// Replaces the TPU kernel `_kernel` of lss2_multimodal_nu_tpu/ops/
// lift_splat_pallas.py (`fused_lift_splat`), which adds each point into a
// VMEM accumulator by a sequential read-modify-write:
//
//   out[b, seg[b, p], :] += depth[b, p] * feat[b, fidx[b, p], :]
//
// over every frustum point p; points with depth 0 (invalid ones) add
// nothing. A row index out of range stops the kernel with a trap, as a
// device-side assert would. The lifted (B, P, C) frustum tensor is never
// built.
//
// Bound on the H100: bytes. At the flagship's B=6 in bf16 the function must
// read the feature rows that live points hit (at most 1.6 MB), depth, seg
// and fidx (3.1 MB) and write the (B, 40000, 128) output (61 MB): 66 MB,
// 0.0198 ms at 3.35 TB/s; the output is 93% of it. So the design writes each output row exactly once, in feat's dtype,
// and touches nothing else of that size: no float32 accumulator to zero, no
// cast pass, no atomics in L2. First the points are sorted by key (row <<
// bbits | b; `csr.cuh::build_csr`, a stable sort on the device with no host sync).
// Then one kernel does two kinds of work side by side (`lift_splat_kernel`):
// only 2608 of the 240000 rows have points at the flagship's B=6 (16 on
// average, 75 at most), and their sums are chains of dependent loads, while
// the rest is a stream of zero stores at the card's write rate. Lane groups
// of the first blocks (16 lanes in bf16, 32 in float at C=128;
// `lift_splat.cuh`) find the runs in the sorted points, gather each run's
// feature rows with 16-byte loads (feat stays in L2), sum them in float32
// registers in sorted order and store the row once; the other blocks sweep
// the output as a fill kernel does and store the zeros of the empty rows.
// The stable sort fixes the order of every sum, so the output repeats bit
// for bit (the TPU kernel's sequential sum does too). The TPU version's
// VMEM accumulator and its stripes have no counterpart.
#include "csr.cuh"
#include "lift_splat.cuh"

namespace {

using namespace lss::splat;
using lss::kThreads;
using lss::csr::align256;

// The CSR key of output row (b, v), row = b * n_voxels + v.
__device__ __forceinline__ int row_key(int row, int n_voxels, int bbits) {
  const int b = row / n_voxels;
  return ((row - b * n_voxels) << bbits) | b;
}

// One lane group's output row (b, v): its run of sorted points [k, k1)
// summed in float32 registers in sorted order, stored once.
template <typename T, int K>
__device__ __forceinline__ void splat_row(const T* __restrict__ feat,
                                          const float* __restrict__ depth,
                                          const int* __restrict__ fidx,
                                          const int* __restrict__ order, T* __restrict__ out,
                                          int row, int k, int k1, int r, int c, int n_voxels,
                                          const Group& grp, int lane, unsigned mask) {
  using V = lss::Vec<T>;
  const int G = 1 << grp.glog;
  const size_t row_bytes = (size_t)c * sizeof(T);
  const char* fb = reinterpret_cast<const char*>(feat) + (size_t)(row / n_voxels) * r * row_bytes;
  float acc[K][V::N];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int e = 0; e < V::N; ++e) acc[j][e] = 0.f;

  for (int k0 = k; k0 < k1; k0 += G) {
    const int n = min(G, k1 - k0);
    // lane t loads the metadata of the run's point k0 + t
    float d = 0.f;
    int f = 0;
    if (lane < n) {
      const int i = order[k0 + lane];
      d = depth[i];
      f = fidx[i];
      if ((unsigned)f >= (unsigned)r) __trap();
    }
    for (int t0 = 0; t0 < n; t0 += kInFlight) {
      uint4 raw[kInFlight][K];
      float dt[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int t = t0 + u;
        dt[u] = __shfl_sync(mask, d, t & (G - 1), G);
        const int ft = __shfl_sync(mask, f, t & (G - 1), G);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int s = lane + j * G;
          raw[u][j] = t < n && s < grp.slices ? lss::ld16(fb + (size_t)ft * row_bytes + s * 16)
                                              : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (t0 + u >= n) continue;  // the same for every lane of the group
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float x[V::N];
          V::unpack(raw[u][j], x);
#pragma unroll
          for (int e = 0; e < V::N; ++e) acc[j][e] = fmaf(dt[u], x[e], acc[j][e]);
        }
      }
    }
  }
  char* dst = reinterpret_cast<char*>(out) + (size_t)row * row_bytes;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = lane + j * G;
    if (s < grp.slices) *reinterpret_cast<uint4*>(dst + s * 16) = V::pack(acc[j]);
  }
}

constexpr int kZeroInFlight = 4;  // 16-byte zero stores a thread prepares together

// The forward grid has two kinds of block, which run side by side. At the
// flagship's B=6 only 2608 of the 240000 rows have points (16 each on
// average, 75 at most): their sums are chains of dependent loads (run
// bounds, point ids, depths and feature rows), the rest is a stream of zero
// stores as fast as the card writes. So the first `run_blocks` blocks find
// the runs: a lane group takes G consecutive sorted positions, and for each
// position that starts a run (its key differs from the one before) it sums
// the run and stores its row. The other blocks store the zeros of the empty
// rows, sweeping the output from end to end as a fill does. Every row is
// written once, by one of the two.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    lift_splat_kernel(const T* __restrict__ feat, const float* __restrict__ depth,
                      const int* __restrict__ fidx, const int* __restrict__ order,
                      const unsigned* __restrict__ sorted, const int* __restrict__ rowptr,
                      T* __restrict__ out, int r, int c, int n_voxels, int rows, int n_points,
                      int bbits, int run_blocks, Group grp) {
  const int G = 1 << grp.glog;
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask = group_mask(grp.glog);
  const unsigned keys = (unsigned)n_voxels << bbits;
  if ((int)blockIdx.x < run_blocks) {
    const int k0 = (blockIdx.x * kThreads + threadIdx.x) & ~(G - 1), k = k0 + lane;
    unsigned key = keys;
    bool start = false;
    if (k < n_points) {
      key = sorted[k];
      start = key < keys && (k == 0 || sorted[k - 1] != key);
    }
    unsigned starts = __ballot_sync(mask, start) >> ((threadIdx.x & 31) & ~(G - 1));
    if (G < 32) starts &= (1u << G) - 1u;
    while (starts != 0u) {  // the same for every lane of the group
      const int t = __ffs(starts) - 1;
      starts &= starts - 1u;
      const unsigned kt = __shfl_sync(mask, key, t, G);
      const int b = (int)(kt & ((1u << bbits) - 1u)), v = (int)(kt >> bbits);
      splat_row<T, K>(feat, depth, fidx, order, out, b * n_voxels + v, k0 + t, rowptr[kt + 1], r,
                      c, n_voxels, grp, lane, mask);
    }
    return;
  }
  // zeros: the output as a flat array of 16-byte slices; a zero block
  // takes kZeroInFlight * kThreads consecutive ones, thread i of it slices
  // i, i + kThreads, ..., whose rows' bounds it loads together
  const int slices = rows * grp.slices;
  const int s0 = (blockIdx.x - run_blocks) * kThreads * kZeroInFlight + threadIdx.x;
  uint4* dst = reinterpret_cast<uint4*>(out);
  bool empty[kZeroInFlight];
#pragma unroll
  for (int u = 0; u < kZeroInFlight; ++u) {
    const int s = s0 + u * kThreads;
    empty[u] = false;
    if (s < slices) {
      const int key = row_key(s / grp.slices, n_voxels, bbits);
      empty[u] = rowptr[key] == rowptr[key + 1];
    }
  }
#pragma unroll
  for (int u = 0; u < kZeroInFlight; ++u)
    if (empty[u]) dst[s0 + u * kThreads] = make_uint4(0u, 0u, 0u, 0u);
}

template <typename T>
int forward(const void* feat, const void* depth, const void* seg, const void* fidx,
            void* scratch, long long scratch_bytes, void* out, int b, int p, int r, int c,
            int n_voxels, void* stream) {
  Group grp;
  if (!group_for<T>(c, &grp)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rows = b * n_voxels, total = b * p, bbits = bits_for(b - 1);
  // scratch: the CSR's order and rowptr, then the index preparation's own
  const size_t order_bytes = align256((size_t)total * 4);
  const size_t rowptr_bytes = align256(((size_t)(n_voxels << bbits) + 1) * 4);
  if ((size_t)scratch_bytes < order_bytes + rowptr_bytes) return (int)cudaErrorInvalidValue;
  int* order = (int*)scratch;
  int* rowptr = (int*)((char*)scratch + order_bytes);
  const unsigned* sorted = nullptr;
  cudaError_t e = lss::csr::build_csr(
      (const float*)depth, (const int*)seg, (char*)scratch + order_bytes + rowptr_bytes,
      (size_t)scratch_bytes - order_bytes - rowptr_bytes, order, rowptr, b, p, n_voxels, st,
      &sorted);
  if (e != cudaSuccess) return (int)e;
  const long long threads = (long long)rows << grp.glog;
  if (threads == 0) return 0;
  // a thread per sorted position for the runs, and for the zeros a thread per
  // kZeroInFlight slices of the output, as a fill kernel has: the zeros wait
  // on loads of rowptr, and only many threads in flight hide them
  const int run_blocks = (total + kThreads - 1) / kThreads;
  const int per_block = kThreads * kZeroInFlight;
  const long long fill_blocks = ((long long)rows * grp.slices + per_block - 1) / per_block;
  const int k = per_lane(grp);
  auto kernel = k == 1 ? lift_splat_kernel<T, 1>
                        : (k == 2 ? lift_splat_kernel<T, 2> : lift_splat_kernel<T, 4>);
  kernel<<<(unsigned)(run_blocks + fill_blocks), kThreads, 0, st>>>(
      (const T*)feat, (const float*)depth, (const int*)fidx, order, sorted, rowptr, (T*)out, r, c,
      n_voxels, rows, total, bbits, run_blocks, grp);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch for the CSR of (B, P) points by row:
// `lift_splat_sort`'s (with order and rowptr outside it), and, with
// `forward`, the forward's (order and rowptr inside it).
extern "C" long long lift_splat_scratch(int b, int p, int n_rows, int forward) {
  const int n = b * p, bbits = bits_for(b - 1);
  size_t bytes = lss::csr::build_csr_bytes(b, p, n_rows);
  if (forward) bytes += align256((size_t)n * 4) + align256(((size_t)(n_rows << bbits) + 1) * 4);
  return (long long)bytes;
}

// The CSR of the (B, P) points by row (`csr.cuh::build_csr`); weight may be null
// (every point live).
extern "C" int lift_splat_sort(const void* weight, const void* row, void* scratch,
                               long long scratch_bytes, void* order, void* rowptr, int b, int p,
                               int n_rows, void* stream) {
  return (int)lss::csr::build_csr((const float*)weight, (const int*)row, scratch,
                                  (size_t)scratch_bytes, (int*)order, (int*)rowptr, b, p, n_rows,
                                  (cudaStream_t)stream);
}

// The forward: the CSR of the points by voxel, then the kernel.
extern "C" int lift_splat_f32(const void* feat, const void* depth, const void* seg,
                              const void* fidx, void* scratch, long long scratch_bytes, void* out,
                              int b, int p, int r, int c, int n_voxels, void* stream) {
  return forward<float>(feat, depth, seg, fidx, scratch, scratch_bytes, out, b, p, r, c,
                        n_voxels, stream);
}

extern "C" int lift_splat_bf16(const void* feat, const void* depth, const void* seg,
                               const void* fidx, void* scratch, long long scratch_bytes,
                               void* out, int b, int p, int r, int c, int n_voxels,
                               void* stream) {
  return forward<__nv_bfloat16>(feat, depth, seg, fidx, scratch, scratch_bytes, out, b, p, r, c,
                                n_voxels, stream);
}
