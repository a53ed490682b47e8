// The sorted CSR of points by key that the lift-splat kernels and the
// deformable-sampling backward reduce over, built on the device with no host
// sync.
//
// Each of n points has an unsigned key. CUB's stable radix sort over the
// key's bits [lo_bit, hi_bit) orders the points, and rowptr[k], for k in
// [0, keys], is the first sorted position whose key is k or more: the points
// of key k are order[rowptr[k]:rowptr[k + 1]], in point order where the
// points arrive ordered by the key's bits below lo_bit. Every sum over such
// a run has one fixed order, so the kernels need no float atomics and their
// results repeat bit for bit from run to run.
//
// The scratch: the keys, the ids 0..n-1, the sorted keys, then CUB's own
// storage. A caller writes the first two itself (`Arrays`) and calls
// `sort`, or lets `build_csr` write lift-splat's keys.
#pragma once

#include <cub/device/device_radix_sort.cuh>

#include "common.cuh"

namespace lss {
namespace csr {

inline size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// Bytes of the keys, the ids and the sorted keys of n points.
inline size_t scratch_head(int n) { return 3 * align256((size_t)n * 4); }

// CUB's storage for the sort of n points over bits [lo_bit, hi_bit).
inline size_t sort_temp_bytes(int n, int lo_bit, int hi_bit) {
  size_t temp = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, temp, (const unsigned*)nullptr, (unsigned*)nullptr,
                                  (const int*)nullptr, (int*)nullptr, n, lo_bit, hi_bit);
  return temp;
}

struct Arrays {
  unsigned* key;     // the caller's keys
  int* id;           // the caller's ids, id[i] = i
  unsigned* sorted;  // the sorted keys, written by `sort`
};

inline Arrays arrays(void* scratch, int n) {
  char* base = (char*)scratch;
  const size_t part = align256((size_t)n * 4);
  return {(unsigned*)base, (int*)(base + part), (unsigned*)(base + 2 * part)};
}

// rowptr[k] = the first sorted position whose key is k or more, for k in
// [0, keys]: a binary search per entry over the n sorted keys.
__global__ void __launch_bounds__(kThreads)
    rowptr_kernel(const unsigned* __restrict__ key, int n, int* __restrict__ rowptr, int keys) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v > keys) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] < (unsigned)v) lo = mid + 1;
    else hi = mid;
  }
  rowptr[v] = lo;
}

// The CSR of n points whose keys and ids are in `scratch` (`arrays`): order
// (n) and rowptr (keys + 1), through scratch_head(n) bytes and then the
// sort's storage.
inline cudaError_t sort(void* scratch, size_t scratch_bytes, int n, int lo_bit, int hi_bit,
                        int keys, int* order, int* rowptr, cudaStream_t st) {
  const size_t head = scratch_head(n);
  if (scratch_bytes < head) return cudaErrorInvalidValue;
  const Arrays a = arrays(scratch, n);
  if (n > 0) {
    size_t temp = scratch_bytes - head;
    const cudaError_t e = cub::DeviceRadixSort::SortPairs((char*)scratch + head, temp, a.key,
                                                          a.sorted, a.id, order, n, lo_bit,
                                                          hi_bit, st);
    if (e != cudaSuccess) return e;
  }
  rowptr_kernel<<<keys / kThreads + 1, kThreads, 0, st>>>(a.sorted, n, rowptr, keys);
  return cudaGetLastError();
}

// ---- lift-splat's keys (`lift_splat.cuh`): of (B, P) points by row.
//
// key[i] of point i = b * P + p: (row[i] << bbits) | b for a live point
// (weight[i] != 0, or every point without weights), (n_rows << bbits) | b
// for any other, which sorts after every row; id[i] = i. A live point's row
// out of range stops the kernel with a trap.
__global__ void __launch_bounds__(kThreads)
    keys_kernel(const float* __restrict__ weight, const int* __restrict__ row,
                unsigned* __restrict__ key, int* __restrict__ id, int p, int n_rows, int bbits,
                int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const bool live = weight == nullptr || weight[i] != 0.f;
  const int r = row[i];
  if (live && (unsigned)r >= (unsigned)n_rows) __trap();
  key[i] = ((unsigned)(live ? r : n_rows) << bbits) | (unsigned)(i / p);
  id[i] = i;
}

// Bytes of `build_csr`'s scratch for (B, P) points over n_rows rows.
inline size_t build_csr_bytes(int b, int p, int n_rows) {
  const int bbits = bits_for(b - 1);
  return scratch_head(b * p) + sort_temp_bytes(b * p, bbits, bbits + bits_for(n_rows));
}

// The CSR of the (B, P) points by row into order (B*P) and rowptr
// ((n_rows << bbits) + 1), through `scratch` (`build_csr_bytes`). The sort
// runs over the row field alone, bits [bbits, bbits + bits_for(n_rows)) of
// the key: 16 bits, two passes, at the flagship's 40000 voxels. The points
// arrive ordered by b, then p, and the sort is stable, so it orders them by
// the whole key (row, b) and, within a key, by p. `sorted_keys`, if given,
// receives the sorted keys (in the scratch).
inline cudaError_t build_csr(const float* weight, const int* row, void* scratch,
                             size_t scratch_bytes, int* order, int* rowptr, int b, int p,
                             int n_rows, cudaStream_t st, const unsigned** sorted_keys = nullptr) {
  const int total = b * p, bbits = bits_for(b - 1);
  if (scratch_bytes < scratch_head(total)) return cudaErrorInvalidValue;
  const Arrays a = arrays(scratch, total);
  if (sorted_keys != nullptr) *sorted_keys = a.sorted;
  if (total > 0) {
    keys_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(weight, row, a.key, a.id,
                                                                         p, n_rows, bbits, total);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return sort(scratch, scratch_bytes, total, bbits, bbits + bits_for(n_rows), n_rows << bbits,
              order, rowptr, st);
}

}  // namespace csr
}  // namespace lss
