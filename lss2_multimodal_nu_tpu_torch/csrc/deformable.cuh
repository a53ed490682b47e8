// Shared pieces of the deformable-sampling kernels (forward and backward):
// how a block's lanes map onto queries and 16-byte slices of the value rows,
// and the bilinear geometry of one sample.
//
// A value row holds dh channels, `slices` = dh * sizeof(T) / 16 slices of
// 16 bytes (8 bf16 or 4 floats; dh a multiple of 8). A group of G lanes, the
// slices rounded up to a power of two and at most 32, serves one query: lane
// j of the group owns slices j, j + G, ... (one at dh <= 256 in bf16, 128 in
// float). So a warp serves 32 / G queries (8 in bf16 at dh = 32, 4 in float)
// and every corner of a sample is one 16-byte load per lane. The 256 threads
// of a block serve a tile of the query grid, kTileW queries wide and
// 256 / G / kTileW rows high, where the query grid has rows of w queries (the
// BEV grid when n = h * w): neighbouring queries sample neighbouring cells,
// which the tile keeps in one SM's L1. blockIdx.y is the (batch, head), the
// slowest index, so that the few value maps in flight stay in L2.
#pragma once

#include "common.cuh"

namespace lss {
namespace deform {

constexpr int kTileW = 8;     // queries across a block's tile
constexpr int kInFlight = 4;  // points whose corner gathers a lane issues together

struct Layout {
  int slices;   // 16-byte slices in a row of dh channels
  int glog;     // log2 of the lanes that serve one query
  int rows;     // rows of the block's tile
  int tiles_x;  // tiles across a row of w queries
  int tiles;    // tiles over the n queries of one (batch, head)
};

template <typename T>
inline Layout layout(int n, int w, int dh) {
  Layout l;
  l.slices = dh * (int)sizeof(T) / 16;
  l.glog = 0;
  while ((1 << l.glog) < l.slices && l.glog < 5) ++l.glog;
  l.rows = kThreads / (1 << l.glog) / kTileW;
  l.tiles_x = (w + kTileW - 1) / kTileW;
  const int qrows = (n + w - 1) / w;
  l.tiles = l.tiles_x * ((qrows + l.rows - 1) / l.rows);
  return l;
}

// This lane's query q (live when it exists) and its first slice j.
struct Lane {
  int q, j;
  bool live;
};

__device__ __forceinline__ Lane lane_of(const Layout& l, int n, int w) {
  const int t = threadIdx.x >> l.glog;  // query slot of the block
  const int qx = (blockIdx.x % l.tiles_x) * kTileW + t % kTileW;
  const int qy = (blockIdx.x / l.tiles_x) * l.rows + t / kTileW;
  Lane me;
  me.j = threadIdx.x & ((1 << l.glog) - 1);
  me.q = qy * w + qx;
  me.live = qx < w && me.q < n;
  return me;
}

// Bilinear geometry of one sample (align_corners=False, zero padding):
// fx = lx*w - 0.5, x0 = floor(fx), wx = fx - x0 (and the same for y), the
// map row of corner 00 and which of the corners 00, 01, 10, 11 lie inside.
// The one place where a location becomes a cell and weights: the forward,
// and the backward's key kernel, dv passes and query pass all call it, so
// that the cell a point is sorted under and the corner weights it adds with
// agree to the bit. fx is one fused multiply-add, written out, so that no
// call site depends on what the compiler contracts.
struct Sample {
  float wx, wy;
  int x0, y0;
  int row;
  bool in[4];
};

__device__ __forceinline__ Sample sample(float lx, float ly, int h, int w) {
  const float fx = __fmaf_rn(lx, (float)w, -0.5f), fy = __fmaf_rn(ly, (float)h, -0.5f);
  const float x0f = floorf(fx), y0f = floorf(fy);
  Sample s;
  s.wx = fx - x0f;
  s.wy = fy - y0f;
  s.x0 = (int)x0f;
  s.y0 = (int)y0f;
  s.row = s.y0 * w + s.x0;
  const bool x_in[2] = {s.x0 >= 0 && s.x0 < w, s.x0 + 1 >= 0 && s.x0 + 1 < w};
  const bool y_in[2] = {s.y0 >= 0 && s.y0 < h, s.y0 + 1 >= 0 && s.y0 + 1 < h};
#pragma unroll
  for (int k = 0; k < 4; ++k) s.in[k] = y_in[k >> 1] && x_in[k & 1];
  return s;
}

__device__ __forceinline__ float corner_weight(float wx, float wy, int k) {
  return ((k >> 1) ? wy : 1.f - wy) * ((k & 1) ? wx : 1.f - wx);
}

__device__ __forceinline__ float corner_weight(const Sample& s, int k) {
  return corner_weight(s.wx, s.wy, k);
}

// Map-row offset of corner k from corner 00.
__device__ __forceinline__ int corner_row(const Sample& s, int k, int w) {
  return s.row + (k >> 1) * w + (k & 1);
}

// 16-byte loads and the float conversions of a slice (`common.cuh`).
using ::lss::ld16;
using ::lss::Vec;

}  // namespace deform
}  // namespace lss
