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
//   dv[bh, corner_k, :] += attn * wt_k * g[bh, q, :]     (float32)
//   dattn = sum_k wt_k * rc_k
//   dlx   = w * attn * ((1-wy)(rc_01 - rc_00) + wy(rc_11 - rc_10))
//   dly   = h * attn * ((1-wx)(rc_10 - rc_00) + wx(rc_11 - rc_01))
//
// Every sum has one fixed order, so the four gradients, and a train step,
// repeat bit for bit from run to run, as the TPU kernel's do (it adds dv by
// sequential read-modify-writes over a grid of "arbitrary" dimensions and
// folds its stripes in a fixed order). dv, where many points add into one
// row, is summed in gather form over the points sorted by cell: no float
// atomics, each row written once, and no zero fill.
//  1. Keys (`deform_sample_bwd_keys`): point (bh, p, q) gets bh * cells plus
//     the cell of its corner 00 on a grid of (h+1) x (w+1) cells with a
//     border of one at the top and the left (x0 or y0 is -1 where other
//     corners are inside); a point with no corner inside gets bh_count *
//     cells, which sorts after every cell. The same call of
//     `deformable.cuh::sample` gives the point's record, (q, attn, wx, wy)
//     in 16 bytes, from which the dv passes take its corner weights: the
//     cell a point is sorted under and the weights it adds with agree.
//  2. The CSR (`csr.cuh::sort`): CUB's stable radix sort over the whole key
//     (22 bits at the flagship's B=8: 64 maps of 40401 cells), then the row
//     offsets. A cell's points keep their (p, q) order, and (batch, head) is
//     the slowest index of the sorted list, as of every grid here, so the
//     one map's points, g and dv in flight stay in L2.
//  3. dv (`deform_sample_bwd_dv`): a lane group owns one dv row (bh, y, x),
//     to which the points of cells (y-1, x-1), (y-1, x), (y, x-1) and
//     (y, x) add with their corners 11, 10, 01 and 00. It walks those four
//     buckets in that order, each in sorted order (one 16-byte record a
//     point), sums attn * wt_k * g[q] in float32 registers and writes the
//     row once. Learned offsets can pile many points into one cell: a
//     bucket of more than `chunk` points is summed ahead
//     (`deform_sample_bwd_chunks`) in pieces cut at every multiple of
//     `chunk` in the sorted list, one lane group a piece, each piece's four
//     corner sums written to a slot of its own; the row adds the bucket's
//     slots in order. Both levels have a fixed order, and no group walks
//     more than 4 * chunk points or slots.
//  4. The query pass (`deform_sample_bwd_query`): per point, rc_k as the
//     lane's partial dot over its channels, summed by __shfl_xor inside the
//     query's lane group (a fixed order), and dlx, dly, dattn written once.
//
// Bound on the H100: memory. The bytes that must cross HBM are v and g once,
// lx/ly/attn once, the float32 dv once and the three small gradients once;
// the gathers of corners (query pass) and of g rows and point records (dv
// pass) land in L2. The lanes follow the forward's layout (`deformable.cuh`):
// a few lanes a query or dv row, each owning 16-byte slices of the channels,
// a block's rows a 2-D tile of the grid. The TPU's VMEM gradient table, RMW
// stripes, hi/lo selector products and quadrant-replicated cotangent have no
// counterpart here.
#include "csr.cuh"
#include "deformable.cuh"

namespace {

using namespace lss::deform;
using lss::kThreads;
namespace csr = lss::csr;

// Where the parts of the backward's scratch lie.
struct Plan {
  int total;             // bh * npts * n points
  int cells;             // (h + 1) * (w + 1) cells of one map
  int keys;              // bh * cells live keys; a dead point's key is `keys`
  int hi_bit;            // the sort's key bits
  int blocks;            // chunk-sized blocks of sorted positions, 2 slots each
  size_t order_off, rowptr_off, rec_off, partial_off, bytes;
};

Plan plan(int bh, int npts, int n, int h, int w, int dh, int chunk) {
  Plan p;
  p.total = bh * npts * n;
  p.cells = (h + 1) * (w + 1);
  p.keys = bh * p.cells;
  p.hi_bit = lss::bits_for(p.keys);
  p.blocks = (p.total + chunk - 1) / chunk;
  p.order_off = csr::align256(csr::scratch_head(p.total) +
                              csr::sort_temp_bytes(p.total, 0, p.hi_bit));
  p.rowptr_off = p.order_off + csr::align256((size_t)p.total * 4);
  p.rec_off = p.rowptr_off + csr::align256(((size_t)p.keys + 1) * 4);
  p.partial_off = p.rec_off + csr::align256((size_t)p.total * sizeof(float4));
  p.bytes = p.partial_off + (size_t)2 * p.blocks * 4 * dh * sizeof(float);
  return p;
}

bool bad_args(int bh, int npts, int n, int h, int w, int dh, int chunk) {
  return dh % 8 != 0 || bh < 1 || npts < 1 || n < 1 || h < 1 || w < 1 || chunk < 1;
}

// ---- 1. keys and records: point i = (bh * npts + p) * n + q
__global__ void __launch_bounds__(kThreads)
    deform_sample_bwd_keys(const float* __restrict__ lx, const float* __restrict__ ly,
                           const float* __restrict__ attn, unsigned* __restrict__ key,
                           int* __restrict__ id, float4* __restrict__ rec, int per_map, int n,
                           int h, int w, int cells, int keys, int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const Sample s = sample(lx[i], ly[i], h, w);
  const bool live = s.x0 >= -1 && s.x0 < w && s.y0 >= -1 && s.y0 < h;
  key[i] = live ? (unsigned)((i / per_map) * cells + (s.y0 + 1) * (w + 1) + s.x0 + 1)
                : (unsigned)keys;
  id[i] = i;
  rec[i] = make_float4(__int_as_float(i % n), attn[i], s.wx, s.wy);
}

// ---- 3. dv

// The float32 sums of a lane's slice, V::N floats, from or to memory.
template <int N>
__device__ __forceinline__ void load_floats(const float* src, float* f) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + e);
    f[e] = x.x;
    f[e + 1] = x.y;
    f[e + 2] = x.z;
    f[e + 3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* dst, const float* f) {
#pragma unroll
  for (int e = 0; e < N; e += 4)
    *reinterpret_cast<float4*>(dst + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
}

// The operands of the dv sums: the sorted points and their records.
struct Points {
  const int* order;    // sorted position -> point
  const float4* rec;   // point -> (q as int bits, attn, wx, wy)
  int n, h, w;
};

// One lane group's sum over the sorted positions [k, k1) of one map, on the
// lane's slice s of g (gb: the map's g), into acc[c] for NC corners: the
// one `corner` (NC = 1) or all four (NC = 4), each acc[c] += attn * wt *
// g[q] point after point in sorted order. Lane t of the group loads the
// record of position k0 + t; the group then issues kInFlight points'
// 16-byte slices of g together.
template <typename T, int NC>
__device__ __forceinline__ void walk(float (&acc)[NC][Vec<T>::N], int k, int k1, int corner,
                                     const Points& pts, const char* gb, size_t row_bytes, int s,
                                     bool own, int glog, unsigned mask) {
  using V = Vec<T>;
  const int G = 1 << glog;
  const int lane = threadIdx.x & (G - 1);
  for (int k0 = k; k0 < k1; k0 += G) {
    const int cnt = min(G, k1 - k0);
    int q = 0;
    float aw[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) aw[c] = 0.f;
    if (lane < cnt) {
      const float4 r = pts.rec[pts.order[k0 + lane]];
      q = __float_as_int(r.x);
#pragma unroll
      for (int c = 0; c < NC; ++c) aw[c] = r.y * corner_weight(r.z, r.w, NC == 1 ? corner : c);
    }
    for (int t0 = 0; t0 < cnt; t0 += kInFlight) {
      uint4 raw[kInFlight];
      float awt[kInFlight][NC];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int t = (t0 + u) & (G - 1);
        const int qt = __shfl_sync(mask, q, t, G);
#pragma unroll
        for (int c = 0; c < NC; ++c) awt[u][c] = __shfl_sync(mask, aw[c], t, G);
        raw[u] = t0 + u < cnt && own ? lss::ld16(gb + (size_t)qt * row_bytes + s * 16)
                                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (t0 + u >= cnt) continue;  // the same for every lane of the group
        float f[V::N];
        V::unpack(raw[u], f);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < V::N; ++e) acc[c][e] = fmaf(awt[u][c], f[e], acc[c][e]);
      }
    }
  }
}

// The pieces of the buckets of more than `chunk` points. Block t of the
// sorted positions, [t * chunk, (t + 1) * chunk), meets at most two such
// buckets: piece 0 is the one at position t * chunk, from there to its end
// or the block's; piece 1 one that starts inside the block, from its start
// to the block's end (it is longer than the block). A lane group per (t,
// piece) writes the piece's four corner sums to slot 2 t + piece, (slot, 4,
// dh) floats; a piece that does not exist writes nothing and no row reads
// its slot.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_bwd_chunks(Points pts, const T* __restrict__ g,
                             const unsigned* __restrict__ sorted, const int* __restrict__ rowptr,
                             float* __restrict__ partial, int total, int keys, int cells, int dh,
                             int chunk, int slices, int glog) {
  using V = Vec<T>;
  const int G = 1 << glog;
  const int gi = (int)((blockIdx.x * (unsigned)kThreads + threadIdx.x) >> glog);
  const int t = gi >> 1, piece = gi & 1;
  if ((long long)t * chunk >= total) return;
  const int pos0 = t * chunk, end = min(pos0 + chunk, total);
  const unsigned first = sorted[pos0];
  const unsigned key = piece == 0 ? first : sorted[end - 1];
  if (key >= (unsigned)keys || (piece == 1 && key == first)) return;
  const int b0 = rowptr[key], b1 = rowptr[key + 1];
  if (b1 - b0 <= chunk) return;  // a short bucket: its rows walk it themselves
  const int k = piece == 0 ? pos0 : b0, k1 = min(b1, end);
  const size_t row_bytes = (size_t)dh * sizeof(T);
  const char* gb = reinterpret_cast<const char*>(g) + (size_t)(key / cells) * pts.n * row_bytes;
  const unsigned mask = lss::group_mask(glog);
  float* slot = partial + (size_t)(2 * t + piece) * 4 * dh;
  for (int s0 = 0; s0 < slices; s0 += G) {
    const int s = s0 + (threadIdx.x & (G - 1));
    const bool own = s < slices;
    float acc[4][V::N];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < V::N; ++e) acc[c][e] = 0.f;
    walk<T, 4>(acc, k, k1, 0, pts, gb, row_bytes, s, own, glog, mask);
    if (own)
#pragma unroll
      for (int c = 0; c < 4; ++c) store_floats<V::N>(slot + c * dh + s * V::N, acc[c]);
  }
}

constexpr int kSlotsInFlight = 4;  // a long bucket's slots a lane loads together

// dv row (bh, y, x) per lane group, the map's rows as the query grid of
// `deformable.cuh` (n = h * w).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_bwd_dv(Points pts, const T* __restrict__ g, const int* __restrict__ rowptr,
                         const float* __restrict__ partial, float* __restrict__ dv, Layout l,
                         int dh, int cells, int chunk) {
  using V = Vec<T>;
  const int h = pts.h, w = pts.w;
  const Lane me = lane_of(l, h * w, w);
  if (!me.live) return;  // a group lives or dies whole, and shuffles within itself
  const int G = 1 << l.glog;
  const unsigned mask = lss::group_mask(l.glog);
  const int bh = blockIdx.y;
  const int y = me.q / w, x = me.q - y * w;
  const size_t row_bytes = (size_t)dh * sizeof(T);
  const char* gb = reinterpret_cast<const char*>(g) + (size_t)bh * pts.n * row_bytes;
  // bucket b = (dy, dx) is cell (y - 1 + dy, x - 1 + dx), at (y + dy) * (w + 1)
  // + x + dx of the bordered grid; this row is its corner 3 - b
  int lo[4], hi[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int key = bh * cells + (y + (b >> 1)) * (w + 1) + x + (b & 1);
    lo[b] = rowptr[key];
    hi[b] = rowptr[key + 1];
  }
  float* out = dv + ((size_t)bh * h * w + me.q) * dh;
  for (int s0 = 0; s0 < l.slices; s0 += G) {
    const int s = s0 + me.j;
    const bool own = s < l.slices;
    float acc[1][V::N];
#pragma unroll
    for (int e = 0; e < V::N; ++e) acc[0][e] = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int corner = 3 - b;
      if (hi[b] - lo[b] <= chunk) {
        walk<T, 1>(acc, lo[b], hi[b], corner, pts, gb, row_bytes, s, own, l.glog, mask);
        continue;
      }
      // a long bucket: its pieces' slots in order (`deform_sample_bwd_chunks`),
      // slot 2 t0 + 1 first where the bucket starts inside block t0
      const int t0 = lo[b] / chunk, t1 = (hi[b] + chunk - 1) / chunk;
      for (int t = t0; t < t1; t += kSlotsInFlight) {
        float f[kSlotsInFlight][V::N];
#pragma unroll
        for (int u = 0; u < kSlotsInFlight; ++u) {
          const int tu = t + u;
          const int slot = 2 * tu + (tu == t0 && lo[b] % chunk != 0);
          if (tu < t1 && own)
            load_floats<V::N>(partial + ((size_t)slot * 4 + corner) * dh + s * V::N, f[u]);
        }
#pragma unroll
        for (int u = 0; u < kSlotsInFlight; ++u)
          if (t + u < t1)
#pragma unroll
            for (int e = 0; e < V::N; ++e) acc[0][e] += own ? f[u][e] : 0.f;
      }
    }
    if (own) store_floats<V::N>(out + s * V::N, acc[0]);
  }
}

// ---- 4. the query pass: rc_k, dlx, dly, dattn per point
template <typename T, int NPTS>
__global__ void __launch_bounds__(kThreads)
    deform_sample_bwd_query(const T* __restrict__ v, const float* __restrict__ lx,
                            const float* __restrict__ ly, const float* __restrict__ attn,
                            const T* __restrict__ g, float* __restrict__ dlx,
                            float* __restrict__ dly, float* __restrict__ dattn, Layout l,
                            int npts, int n, int h, int w, int dh) {
  using V = Vec<T>;
  // points whose lx/ly/attn are loaded together
  constexpr int P = kInFlight;
  // No early return: the lanes of a query group exchange their partial sums,
  // and a lane without a query (or a slice) adds zeros.
  const Lane me = lane_of(l, n, w);
  const int G = 1 << l.glog;
  const int np = NPTS > 0 ? NPTS : npts;
  const int bh = blockIdx.y;
  const size_t row_bytes = (size_t)dh * sizeof(T);
  const char* vb = reinterpret_cast<const char*>(v) + (size_t)bh * h * w * row_bytes;
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

  // one sample's four corners on slice s: the lane's partial dots rc_k
  auto slice = [&](int s, const float* gf, const Sample& sm, bool alive, float* rc) {
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
      slice(me.j, g0, sm, alive[k], rc);
      for (int s = me.j + G; s < l.slices; s += G) {
        float gf[V::N];
        V::unpack(ld16(gq + s * 16), gf);
        slice(s, gf, sm, alive[k], rc);
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
int dv_pass(const void* g, void* scratch, long long scratch_bytes, void* dv, int bh, int npts,
            int n, int h, int w, int dh, int chunk, void* stream) {
  if (bad_args(bh, npts, n, h, w, dh, chunk)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(bh, npts, n, h, w, dh, chunk);
  if ((size_t)scratch_bytes < p.bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  char* base = (char*)scratch;
  const Points pts{(const int*)(base + p.order_off), (const float4*)(base + p.rec_off), n, h, w};
  const int* rowptr = (const int*)(base + p.rowptr_off);
  float* partial = (float*)(base + p.partial_off);
  const Layout l = layout<T>(h * w, w, dh);
  const long long lanes = (long long)2 * p.blocks << l.glog;
  deform_sample_bwd_chunks<T><<<(unsigned)((lanes + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      pts, (const T*)g, csr::arrays(scratch, p.total).sorted, rowptr, partial, p.total, p.keys,
      p.cells, dh, chunk, l.slices, l.glog);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  deform_sample_bwd_dv<T><<<dim3(l.tiles, bh), kThreads, 0, st>>>(
      pts, (const T*)g, rowptr, partial, (float*)dv, l, dh, p.cells, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int query_pass(const void* v, const void* lx, const void* ly, const void* attn, const void* g,
               void* dlx, void* dly, void* dattn, int bh, int npts, int n, int h, int w, int dh,
               void* stream) {
  if (bad_args(bh, npts, n, h, w, dh, 1)) return (int)cudaErrorInvalidValue;
  const Layout l = layout<T>(n, w, dh);
  const auto kernel = npts == 8 ? deform_sample_bwd_query<T, 8> : deform_sample_bwd_query<T, 0>;
  kernel<<<dim3(l.tiles, bh), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)v, (const float*)lx, (const float*)ly, (const float*)attn, (const T*)g,
      (float*)dlx, (float*)dly, (float*)dattn, l, npts, n, h, w, dh);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the backward's scratch (`Plan`): the sort's, the CSR's order and
// row offsets, the points' records, and the slots of the long buckets'
// pieces.
extern "C" long long deform_sample_bwd_scratch(int bh, int npts, int n, int h, int w, int dh,
                                               int chunk) {
  if (bad_args(bh, npts, n, h, w, dh, chunk)) return -1;
  return (long long)plan(bh, npts, n, h, w, dh, chunk).bytes;
}

// Steps 1-2: the points' keys, records and CSR, into the scratch.
extern "C" int deform_sample_bwd_sort(const void* lx, const void* ly, const void* attn,
                                      void* scratch, long long scratch_bytes, int bh, int npts,
                                      int n, int h, int w, int dh, int chunk, void* stream) {
  if (bad_args(bh, npts, n, h, w, dh, chunk)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(bh, npts, n, h, w, dh, chunk);
  if ((size_t)scratch_bytes < p.bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const csr::Arrays a = csr::arrays(scratch, p.total);
  char* base = (char*)scratch;
  deform_sample_bwd_keys<<<(p.total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)lx, (const float*)ly, (const float*)attn, a.key, a.id,
      (float4*)(base + p.rec_off), npts * n, n, h, w, p.cells, p.keys, p.total);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)csr::sort(scratch, p.order_off, p.total, 0, p.hi_bit, p.keys,
                        (int*)(base + p.order_off), (int*)(base + p.rowptr_off), st);
}

// Step 3: dv (bh, h*w, dh) float32 from the sorted points.
extern "C" int deform_sample_bwd_dv_f32(const void* g, void* scratch, long long scratch_bytes,
                                        void* dv, int bh, int npts, int n, int h, int w, int dh,
                                        int chunk, void* stream) {
  return dv_pass<float>(g, scratch, scratch_bytes, dv, bh, npts, n, h, w, dh, chunk, stream);
}

extern "C" int deform_sample_bwd_dv_bf16(const void* g, void* scratch, long long scratch_bytes,
                                         void* dv, int bh, int npts, int n, int h, int w, int dh,
                                         int chunk, void* stream) {
  return dv_pass<__nv_bfloat16>(g, scratch, scratch_bytes, dv, bh, npts, n, h, w, dh, chunk,
                                stream);
}

// Step 4: dlx, dly, dattn (bh, npts, n) float32.
extern "C" int deform_sample_bwd_query_f32(const void* v, const void* lx, const void* ly,
                                           const void* attn, const void* g, void* dlx, void* dly,
                                           void* dattn, int bh, int npts, int n, int h, int w,
                                           int dh, void* stream) {
  return query_pass<float>(v, lx, ly, attn, g, dlx, dly, dattn, bh, npts, n, h, w, dh, stream);
}

extern "C" int deform_sample_bwd_query_bf16(const void* v, const void* lx, const void* ly,
                                            const void* attn, const void* g, void* dlx, void* dly,
                                            void* dattn, int bh, int npts, int n, int h, int w,
                                            int dh, void* stream) {
  return query_pass<__nv_bfloat16>(v, lx, ly, attn, g, dlx, dly, dattn, bh, npts, n, h, w, dh,
                                   stream);
}
