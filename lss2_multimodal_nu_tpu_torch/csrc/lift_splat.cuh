// Shared pieces of the lift-splat kernels (forward and backward): how a
// block's lanes map onto output rows and 16-byte slices of a row, and the
// lane group's shuffles.
//
// Both kernels reduce over a CSR: the points of row r of batch element b are
// a run of a sorted point list, from `ptr[key]` to `ptr[key + 1]` with key =
// (r << bbits) | b (bbits = bits_for(B - 1)), and `order[k]` is the point
// (b * P + p) at sorted position k. A stable sort builds it
// (`csr.cuh::build_csr`), so a row's points keep point order and every
// sum runs in one fixed order: no float atomics, each output row written
// once, and the result repeats bit for bit from run to run.
//
// A row holds c channels, `slices` = c * sizeof(T) / 16 slices of 16 bytes
// (8 bf16 or 4 floats; the wrapper refuses another c). A group of G lanes,
// the slices rounded up to a power of two and at most 32, serves one row:
// lane j owns slices j, j + G, ... (K of them at most). At c = 128 that is
// 16 lanes a row in bf16 and 32 in float, one slice each.
#pragma once

#include "common.cuh"

namespace lss {
namespace splat {

constexpr int kInFlight = 4;  // points whose 16-byte gathers a lane issues together
constexpr int kMaxSlices = 4; // slices a lane may own (K)

using ::lss::bits_for;

struct Group {
  int slices;  // 16-byte slices in a row
  int glog;    // log2 of the lanes that serve one row
};

template <typename T>
inline bool group_for(int c, Group* grp) {
  if (c <= 0 || (c * (int)sizeof(T)) % 16 != 0) return false;
  grp->slices = c * (int)sizeof(T) / 16;
  grp->glog = 0;
  while ((1 << grp->glog) < grp->slices && grp->glog < 5) ++grp->glog;
  return grp->slices <= kMaxSlices << grp->glog;
}

// Slices each lane owns, rounded up to the kernels' instantiations 1, 2, 4.
inline int per_lane(const Group& g) {
  const int k = (g.slices + (1 << g.glog) - 1) >> g.glog;
  return k <= 1 ? 1 : (k <= 2 ? 2 : 4);
}

using ::lss::group_mask;

// Sum over the group's lanes in a fixed order; every lane gets the sum.
__device__ __forceinline__ float group_sum(float v, unsigned mask, int glog) {
  for (int o = (1 << glog) >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, 1 << glog);
  return v;
}

}  // namespace splat
}  // namespace lss
