// Backward of the tap-based multi-scale deformable attention of one level
// (kernel B5b).
//
// Not a TPU kernel: it replaces the JAX package's manual backward
// nmrf_tpu/ops/msda.py:_tap_bwd, a jnp scan over the (2r+1)^2 taps under the
// custom VJP _tap_level_op, whose forward is B5 (msda_taps.cu).
//
// Function, in the forward's notation (msda_taps.cu): given the level map v,
// the samples (dx, dy, aw) and g, the gradient of the output,
//   d aw[q,m,p] = sum over the kept corners (ty, tx) of hat(zy) hat(zx) s,
//   d dy[q,m,p] = sum of aw hat(zx) hat'(zy) s,
//   d dx[q,m,p] = sum of aw hat(zy) hat'(zx) s,
//   d v[ly, lx, m*D + d] = sum over the samples (q, m, p) with a kept corner
//       at (ly, lx) of aw hat(zy) hat(zx) g[q, m*D + d],
// with zy = dy - ty, zx = dx - tx, s = <g[q, m, :], v[base_y + ty,
// base_x + tx, m, :]> and hat'(z) = -sign(z) where |z| < 1, else 0: the JAX
// backward's choice at the kinks, 0 at z = 0 and at |z| = 1.  A corner is
// kept when |ty| <= r, |tx| <= r and it lies on the map, as in the forward;
// nothing else contributes to any of the four results.
//
// On an H tile the queries and v are placed as in the forward
// (msda_taps.cu): query rows qy0 .. qy0 + Hq - 1, v's rows vy0 .. vy0 +
// Hl - 1 of the level's Hg, base cells and the map's edges global.  d v
// then holds the gradient of v's rows from these queries alone (the
// caller's halo exchange returns its halo rows' part to their tiles), and
// the base cells of the query rows, -oy .. Hc - oy - 1 in v's rows, index
// the cell masks.
//
// Design: no float atomics, so two launches give the same bits.  d v is
// gathered per level pixel, not scattered per sample.  For r <= 5 (the swin
// neck's 5: (2r+1)^2 = 121 taps fit in 128 bits) and f <= 8 three kernels
// run:
//   * msda_bwd_sample_kernel: one thread per (query, head), as B5's vector
//     kernel.  It loads its head's D channels of g once, gathers each kept
//     corner's D channels of v, writes d dx, d dy and d aw of its P samples,
//     and writes the (query, head)'s tap mask: bit (ty + r)(2r + 1) + tx + r
//     set for each kept corner, 4 words in planes [B, M, 4, Hq, Wq].
//   * msda_bwd_cell_mask_kernel (f > 1 only): ORs the masks of each base
//     cell's queries into the cell's, [B, M, 4, Hc, Wc].  A base cell's
//     queries form one range per axis (base(q) = floor((2q + 1 + f) / 2f) - 1
//     rises with q): a block of at most f x f queries, cells -1 .. Hl - 1 at
//     f > 1.  At f 1 a cell is its query and the query masks serve.
//   * msda_bwd_gather_kernel: L lanes (the largest power of two up to f^2
//     and 32) per (level pixel, head), in four steps.  (1) The lanes test
//     the pixel's bit in the masks of the (2r+1)^2 base cells within r, a
//     tap each, and ballots give every lane the 121-bit set of kept cells
//     (one lane, at f 1, walks the taps row by row).  (2) At f > 1 the
//     lanes split each kept cell's queries (slot j of the cell's f x f
//     block, row j / f and column j % f, to lane j mod L, at most 2 a lane)
//     and test each one's own bit: a lane keeps a 121-bit set of hits per
//     query slot.  (3) A lane takes
//     its hits in slot and tap order, loads each one's dx, dy, aw and g,
//     and adds its samples' summed weight on the pixel times g to D f32
//     sums in registers.  (4) The lanes' sums meet in a fixed butterfly of
//     shuffles.  So a pixel reads its candidate cells' mask words and the
//     samples that really land on it, where the walk below tests every
//     sample of every candidate cell; the coarse levels, which have few
//     pixels, spread each pixel's cells of f^2 queries over a warp's
//     lanes.  What bounds it is the hits' loads from L2 and their latency:
//     steps 1 and 2 issue their loads in batches (4 mask words, 4 cells'
//     query bits), and step 3 takes one hit at a time, reading g after the
//     samples, so that the kernel fits 64 registers (bf16, D 8) and 32
//     warps an SM hide the loads (two hits' loads at once took 112
//     registers and ran slower).
// Past r 5 or f 8 the sample kernel writes no masks and msda_bwd_walk_kernel
// (the first design) gathers d v: kSlices threads per (level pixel, head)
// walk every base cell within r and test every sample of its queries.
// The vector path (D 8 or 16, P a multiple of 4, every pointer 16-byte
// aligned: the swin neck's M 8, P 4, D 8) moves channels and samples in
// 16-byte vectors; otherwise the same kernels run on scalars, with one
// channel per (pixel, head) job in the value kernels.  The entry reports
// the variant it launched: bit 0 the vector path, bit 1 the masks.
//
// Bound on the H100 (bf16, one extractor of the swin training step: batch 16,
// the left and right images of 8 pairs, query grid 96 x 192, M 8, P 4, D 8):
// bytes.  dx, dy and aw read and their gradients written are 226 MB (f32),
// g 38 MB, v and d v 75 MB at f 1 down to 1.2 MB at f 8: 0.08-0.10 ms at
// 3.35 TB/s (chip_smoke.py:msda_bwd_bound).  The masks are this design's
// own traffic, outside the bound: 38 MB of query masks written and read
// again per launch, and at f > 1 the cell masks (under 10 MB).

#include "common.cuh"

namespace nmrf {

struct MsdaBwdParams {
  int B, Hl, Wl, Hq, Wq, M, D, P, r, f, MD, MP, nq;
  int qy0, vy0;      // global rows of the first query row and of v's first row
  int ylo, yhi;      // v's rows on the level map: [ylo, yhi)
  int taps;          // (2r + 1)^2
  int oy, ox, Hc, Wc;  // base cells -oy .. Hc - oy - 1 (rows of v) by -ox .. Wl - 1
  int lanes;         // lanes per (level pixel, head) job of the gather kernel
  int slots;         // queries of a base cell per lane: ceil(f^2 / lanes), 1 or 2
  int sdiv, fdiv;    // ceil(2^16 / (2r + 1)) and ceil(2^16 / f): see div_small
  int txb, tyb;      // a gather block's tile of level pixels: 2^txb x 2^tyb jobs
  int tiles_x, tiles_y;
  long long qplane;  // Hq * Wq, one word plane of the query masks
  long long cplane;  // Hc * Wc, one word plane of the cell masks
};

constexpr int kThreads = 256;
constexpr int kSlices = 4;      // threads per (level pixel, head) in the walk kernel
constexpr int kMaskWords = 4;   // 128 bits of taps per (query or cell, head)
constexpr int kMaskRadius = 5;  // the largest r whose (2r + 1)^2 taps fit

// the base cell of query coordinate q at level factor f
__device__ __forceinline__ int base_cell(int q, int f) { return (2 * q + 1 + f) / (2 * f) - 1; }

// the first query coordinate in [0, n] whose base cell is at least b
// (base(q) >= b <=> q >= f b + floor(f / 2), the form cell_query takes)
__device__ __forceinline__ int first_query(int b, int f, int n) {
  const int num = 2 * f * (b + 1) - 1 - f;
  return num <= 0 ? 0 : min((num + 1) / 2, n);
}

// the first local query row in [0, Hq] whose base cell is at least row b of v
__device__ __forceinline__ int first_query_row(int b, const MsdaBwdParams& p) {
  const int num = 2 * p.f * (b + p.vy0 + 1) - 1 - p.f;
  const int q = num <= 0 ? 0 : (num + 1) / 2;
  return min(max(q - p.qy0, 0), p.Hq);
}

// d hat(z) / dz as the JAX backward takes it: -sign(z) where |z| < 1, else 0
__device__ __forceinline__ float hat_slope(float z) {
  return fabsf(z) < 1.f ? (z > 0.f ? -1.f : (z < 0.f ? 1.f : 0.f)) : 0.f;
}

// 4 consecutive samples of a [.., M*P] f32 row; on the scalar path those
// past the head's P points read NaN, which every reach test skips
template <bool VEC>
__device__ __forceinline__ void load_points(const float* src, int left, float* dst) {
  if constexpr (VEC) {
    load_vec16(src, dst);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[u] = u < left ? src[u] : __int_as_float(0x7fc00000);
  }
}

// bit t of a 128-bit tap set held as two 64-bit halves
__device__ __forceinline__ void set_tap(unsigned long long& lo, unsigned long long& hi, int t) {
  if (t < 64) lo |= 1ull << t;
  else hi |= 1ull << (t - 64);
}

// one thread per (query, head): d dx, d dy and d aw of the head's P samples,
// and with MASK the (query, head)'s tap mask
template <typename T, int DV, int MASK>
__global__ void __launch_bounds__(kThreads)
msda_bwd_sample_kernel(const T* __restrict__ v, const float* __restrict__ dx,
                       const float* __restrict__ dy, const float* __restrict__ aw,
                       const T* __restrict__ g, float* __restrict__ gdx,
                       float* __restrict__ gdy, float* __restrict__ gaw,
                       uint32_t* __restrict__ qmask, MsdaBwdParams p) {
  constexpr bool VEC = DV > 0;
  constexpr int V = 16 / sizeof(T);
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(p.nq) * p.M) return;
  const int q = static_cast<int>(idx / p.M), m = static_cast<int>(idx % p.M);
  const int qx = q % p.Wq;
  const int qy = (q / p.Wq) % p.Hq;
  const int b = q / (p.Wq * p.Hq);
  const int base_y = base_cell(qy + p.qy0, p.f) - p.vy0, base_x = base_cell(qx, p.f);
  const int S = 2 * p.r + 1;
  const T* vb = v + static_cast<long long>(b) * p.Hl * p.Wl * p.MD + m * p.D;
  const T* gq = g + static_cast<long long>(q) * p.MD + m * p.D;
  const long long row = static_cast<long long>(q) * p.MP + m * p.P;
  float gv[VEC ? DV : 1];
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < DV / V; ++k) load_vec16(gq + k * V, gv + k * V);
  }
  unsigned long long lo = 0, hi = 0;
  const float reach = static_cast<float>(p.r) + 1.f;
  for (int p0 = 0; p0 < p.P; p0 += 4) {
    float ddx[4], ddy[4], a[4], out_x[4], out_y[4], out_a[4];
    load_points<VEC>(dx + row + p0, p.P - p0, ddx);
    load_points<VEC>(dy + row + p0, p.P - p0, ddy);
    load_points<VEC>(aw + row + p0, p.P - p0, a);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      out_x[u] = out_y[u] = out_a[u] = 0.f;
      // beyond r + 1 every corner is dropped (and the int cast stays in range)
      if (!(fabsf(ddx[u]) <= reach) || !(fabsf(ddy[u]) <= reach)) continue;
      const int y0 = static_cast<int>(floorf(ddy[u]));
      const int x0 = static_cast<int>(floorf(ddx[u]));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ty = y0 + i;
        const int ly = base_y + ty;
        if (ty < -p.r || ty > p.r || ly < p.ylo || ly >= p.yhi) continue;
        const float zy = ddy[u] - static_cast<float>(ty);
        const float hy = fmaxf(0.f, 1.f - fabsf(zy));
        const float sy = hat_slope(zy);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int tx = x0 + j;
          const int lx = base_x + tx;
          if (tx < -p.r || tx > p.r || lx < 0 || lx >= p.Wl) continue;
          if constexpr (MASK != 0) set_tap(lo, hi, (ty + p.r) * S + tx + p.r);
          const float zx = ddx[u] - static_cast<float>(tx);
          const float hx = fmaxf(0.f, 1.f - fabsf(zx));
          const float sx = hat_slope(zx);
          const T* src = vb + (static_cast<long long>(ly) * p.Wl + lx) * p.MD;
          float s = 0.f;
          if constexpr (VEC) {
#pragma unroll
            for (int k = 0; k < DV / V; ++k) {
              float c[V];
              load_vec16(src + k * V, c);
#pragma unroll
              for (int e = 0; e < V; ++e) s += gv[k * V + e] * c[e];
            }
          } else {
            for (int d = 0; d < p.D; ++d) s += to_float(gq[d]) * to_float(src[d]);
          }
          out_a[u] += hy * hx * s;
          out_y[u] += a[u] * hx * sy * s;
          out_x[u] += a[u] * hy * sx * s;
        }
      }
    }
    if constexpr (VEC) {
      store_vec16(gdx + row + p0, out_x);
      store_vec16(gdy + row + p0, out_y);
      store_vec16(gaw + row + p0, out_a);
    } else {
      for (int u = 0; u < 4 && p0 + u < p.P; ++u) {
        gdx[row + p0 + u] = out_x[u];
        gdy[row + p0 + u] = out_y[u];
        gaw[row + p0 + u] = out_a[u];
      }
    }
  }
  if constexpr (MASK != 0) {
    uint32_t* dst = qmask + (static_cast<long long>(b) * p.M + m) * kMaskWords * p.qplane +
                    static_cast<long long>(qy) * p.Wq + qx;
    dst[0] = static_cast<uint32_t>(lo);
    dst[p.qplane] = static_cast<uint32_t>(lo >> 32);
    dst[2 * p.qplane] = static_cast<uint32_t>(hi);
    dst[3 * p.qplane] = static_cast<uint32_t>(hi >> 32);
  }
}

// one thread per (head, mask word, base cell): the OR of the cell's query masks
__global__ void __launch_bounds__(kThreads)
msda_bwd_cell_mask_kernel(const uint32_t* __restrict__ qmask, uint32_t* __restrict__ cmask,
                          MsdaBwdParams p) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(p.B) * p.M * kMaskWords * p.cplane) return;
  const int cx = static_cast<int>(idx % p.Wc);
  const long long plane = idx / p.Wc / p.Hc;  // (b * M + m) * 4 + word
  const int cy = static_cast<int>((idx / p.Wc) % p.Hc);
  const uint32_t* src = qmask + plane * p.qplane;
  const int qy1 = first_query_row(cy - p.oy + 1, p);
  const int qx0 = first_query(cx - p.ox, p.f, p.Wq), qx1 = first_query(cx - p.ox + 1, p.f, p.Wq);
  uint32_t bits = 0;
  for (int qy = first_query_row(cy - p.oy, p); qy < qy1; ++qy)
    for (int qx = qx0; qx < qx1; ++qx) bits |= src[static_cast<long long>(qy) * p.Wq + qx];
  cmask[idx] = bits;
}

// the weight on the pixel at tap (ty, tx) of 4 samples, added to w
__device__ __forceinline__ void tap_weight(const float* ddx, const float* ddy, const float* a,
                                           int ty, int tx, float reach, float& w) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (!(fabsf(ddx[u]) <= reach) || !(fabsf(ddy[u]) <= reach)) continue;
    const int y0 = static_cast<int>(floorf(ddy[u]));
    const int x0 = static_cast<int>(floorf(ddx[u]));
    if ((ty != y0 && ty != y0 + 1) || (tx != x0 && tx != x0 + 1)) continue;
    const float hy = fmaxf(0.f, 1.f - fabsf(ddy[u] - static_cast<float>(ty)));
    const float hx = fmaxf(0.f, 1.f - fabsf(ddx[u] - static_cast<float>(tx)));
    w += a[u] * hy * hx;
  }
}

// the D channels (one on the scalar path) of g at src, as f32
template <typename T, int DV>
__device__ __forceinline__ void load_channels(const T* __restrict__ src, float* c) {
  if constexpr (DV > 0) {
    constexpr int V = 16 / sizeof(T);
#pragma unroll
    for (int k = 0; k < DV / V; ++k) load_vec16(src + k * V, c + k * V);
  } else {
    c[0] = to_float(src[0]);
  }
}

// acc[0 .. DT) -> dst, lane 0 of each job
template <typename T, int DV>
__device__ __forceinline__ void store_sums(T* dst, const float* acc) {
  if constexpr (DV > 0) {
    constexpr int V = 16 / sizeof(T);
#pragma unroll
    for (int k = 0; k < DV / V; ++k) store_vec16(dst + k * V, acc + k * V);
  } else {
    dst[0] = from_float<T>(acc[0]);
  }
}

// n / d for n < 128 and d <= 11 as (n * ceil(2^16 / d)) >> 16: the
// multiplier's excess adds under 128 / 2^16 < 0.002 to n / d, whose
// fraction is at most 10 / 11, so the floor is exact (taps over 2r + 1 at
// r <= 5, query slots over f at f <= 8)
__device__ __forceinline__ int div_small(int n, int mul) { return (n * mul) >> 16; }

// the lowest tap of a 128-bit set, taken out of it; -1 when it is empty
__device__ __forceinline__ int pop_tap(unsigned long long& lo, unsigned long long& hi) {
  if (lo) {
    const int t = __ffsll(static_cast<long long>(lo)) - 1;
    lo &= lo - 1;
    return t;
  }
  if (hi) {
    const int t = 63 + __ffsll(static_cast<long long>(hi));
    hi &= hi - 1;
    return t;
  }
  return -1;
}

// the base cell at tap t of level pixel (py, px), (py - ty, px - tx), and
// the query (qy, qx) in slot j (< 64) of the cell's f x f block of queries,
// row j / f, column j % f; false where the cell holds fewer (the border
// cells)
__device__ __forceinline__ bool cell_query(const MsdaBwdParams& p, int py, int px, int t, int j,
                                           int& ty, int& tx, int& qy, int& qx) {
  const int row = div_small(t, p.sdiv);
  ty = row - p.r;
  tx = t - row * (2 * p.r + 1) - p.r;
  const int jy = div_small(j, p.fdiv);
  const int y0 = p.f * (py - ty + p.vy0) + p.f / 2 - p.qy0, x0 = p.f * (px - tx) + p.f / 2;
  qy = max(y0, 0) + jy;
  qx = max(x0, 0) + j - jy * p.f;
  return qy < min(y0 + p.f, p.Hq) && qx < min(x0 + p.f, p.Wq);
}

// p.lanes lanes per (level pixel, head) job on the vector path, per (level
// pixel, channel) job on the scalar one: d v, gathered from the queries
// whose masks hold the pixel's tap, in a fixed order.  Each step issues
// its loads together (kRounds mask words, kBatch cells' query bits), so a
// lane waits on memory once per batch, not once per load.
constexpr int kRounds = 4;       // ballot rounds of step 1 whose loads go together
constexpr int kBatch = 4;        // kept cells whose query bits step 2 loads together
constexpr int kSlotsPerLane = 2; // queries of a cell per lane: f^2 <= 2 * lanes for f <= 8

template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
msda_bwd_gather_kernel(const float* __restrict__ dx, const float* __restrict__ dy,
                       const float* __restrict__ aw, const T* __restrict__ g,
                       const uint32_t* __restrict__ qmask, const uint32_t* __restrict__ cmask,
                       T* __restrict__ dv, MsdaBwdParams p) {
  constexpr bool VEC = DV > 0;
  constexpr int DT = VEC ? DV : 1;  // channels of a job
  const int L = p.lanes;
  const int lane = static_cast<int>(threadIdx.x) & (L - 1);
  const int wlane = static_cast<int>(threadIdx.x & 31);
  const int chans = VEC ? 1 : p.D;
  // a block is a 2^tyb x 2^txb tile of level pixels of one (image, head,
  // channel), blockIdx.x = (((b M + m) chans + c) tiles_y + tile row)
  // tiles_x + tile column: the tile's queries and masks, read again and
  // again by its pixels (a sample's 4 corners are neighbours), stay in the
  // SM's L1; a warp's jobs are neighbouring pixels of one head, whose masks
  // are neighbouring words of one plane.  Every lane stays to the ballots
  // and shuffles; lanes off the map test and sum nothing.
  const int in = static_cast<int>(threadIdx.x) / L;
  const int px = (static_cast<int>(blockIdx.x % p.tiles_x) << p.txb) + (in & ((1 << p.txb) - 1));
  const int py = (static_cast<int>((blockIdx.x / p.tiles_x) % p.tiles_y) << p.tyb) +
                 (in >> p.txb);
  const int bmc = static_cast<int>(blockIdx.x / p.tiles_x / p.tiles_y);
  const int c = bmc % chans, bm = bmc / chans;
  const bool active = px < p.Wl && py < p.Hl;
  const int m = bm % p.M, b = bm / p.M;
  const int S = 2 * p.r + 1;
  const uint32_t* cm = cmask + static_cast<long long>(bm) * kMaskWords * p.cplane;
  const uint32_t* qm = qmask + static_cast<long long>(bm) * kMaskWords * p.qplane;

  // 1. the kept cells: tap t = (ty + r) S + tx + r is the cell (py - ty,
  //    px - tx), bit t of its mask.  One lane (f 1) walks the taps row by
  //    row and tests each tap's cell (a walk over column bounds computed
  //    once per row, the same set, came out of ptxas 12.9 at -O1 and above
  //    keeping cells off the map: nmrf_tpu_torch/tools/walk_probe.py); L
  //    lanes test taps l, l + L, ... and ballots share the bits
  unsigned long long lo = 0, hi = 0;
  if (L == 1) {
    for (int ty = -p.r, t = 0; ty <= p.r && active; ++ty) {
      const int cy = py - ty + p.oy;
      const bool row_on = cy >= 0 && cy < p.Hc;
      for (int tx = -p.r; tx <= p.r; ++tx, ++t) {
        const int cx = px - tx + p.ox;
        if (row_on && cx >= 0 && cx < p.Wc &&
            ((cm[(t >> 5) * p.cplane + static_cast<long long>(cy) * p.Wc + cx] >> (t & 31)) & 1u))
          set_tap(lo, hi, t);
      }
    }
  } else {
    const unsigned group = L == 32 ? 0xffffffffu : (1u << L) - 1;
    for (int t0 = 0; t0 < p.taps; t0 += kRounds * L) {
      bool kept[kRounds];
#pragma unroll
      for (int k = 0; k < kRounds; ++k) {
        const int t = t0 + k * L + lane;
        kept[k] = false;
        if (active && t < p.taps) {
          const int ty = div_small(t, p.sdiv);
          const int cy = py - (ty - p.r) + p.oy, cx = px - (t - ty * S - p.r) + p.ox;
          if (cy >= 0 && cy < p.Hc && cx >= 0 && cx < p.Wc)
            kept[k] = (cm[(t >> 5) * p.cplane + static_cast<long long>(cy) * p.Wc + cx] >>
                       (t & 31)) & 1u;
        }
      }
#pragma unroll
      for (int k = 0; k < kRounds; ++k) {
        const int tb = t0 + k * L;
        const unsigned long long mine =
            (__ballot_sync(0xffffffffu, kept[k]) >> (wlane & ~(L - 1))) & group;
        if (tb < 64) lo |= mine << tb;
        else if (tb < 128) hi |= mine << (tb - 64);
      }
    }
  }

  // 2. the lane's hits: bit t of hit[k] when its query slot j = lane + k L
  //    (row j / f, column j % f of the block) of the kept cell at tap t
  //    holds the pixel's tap in its own mask; at f 1 a cell is its query
  //    and the kept cells are the hits
  unsigned long long hit_lo[kSlotsPerLane], hit_hi[kSlotsPerLane];
  hit_lo[0] = lo;
  hit_hi[0] = hi;
#pragma unroll
  for (int k = 1; k < kSlotsPerLane; ++k) hit_lo[k] = hit_hi[k] = 0;
  if (p.f > 1) {
    hit_lo[0] = hit_hi[0] = 0;
    while (lo | hi) {
      int t[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) t[i] = pop_tap(lo, hi);
      bool h[kBatch][kSlotsPerLane];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
#pragma unroll
        for (int k = 0; k < kSlotsPerLane; ++k) {
          int ty, tx, qy, qx;
          h[i][k] = t[i] >= 0 && k < p.slots && lane + k * L < p.f * p.f &&
                    cell_query(p, py, px, t[i], lane + k * L, ty, tx, qy, qx) &&
                    ((qm[(t[i] >> 5) * p.qplane + static_cast<long long>(qy) * p.Wq + qx] >>
                      (t[i] & 31)) & 1u);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
#pragma unroll
        for (int k = 0; k < kSlotsPerLane; ++k)
          if (h[i][k]) set_tap(hit_lo[k], hit_hi[k], t[i]);
      }
    }
  }

  // 3. the hits in slot and tap order: each query's samples' weight on the
  //    pixel, summed, times its head's g (read after the samples, which
  //    keeps the kernel within 64 registers: occupancy, not loads in
  //    flight, is what the hits need)
  float acc[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d] = 0.f;
  const float reach = static_cast<float>(p.r) + 1.f;
  const int c0 = m * p.D + c;  // first channel, m * D + d
#pragma unroll
  for (int k = 0; k < kSlotsPerLane; ++k) {
    for (int t = pop_tap(hit_lo[k], hit_hi[k]); t >= 0; t = pop_tap(hit_lo[k], hit_hi[k])) {
      int ty, tx, qy, qx;
      cell_query(p, py, px, t, lane + k * L, ty, tx, qy, qx);
      const long long q = static_cast<long long>(b) * p.qplane +
                          static_cast<long long>(qy) * p.Wq + qx;
      float w = 0.f;
      for (int p0 = 0; p0 < p.P; p0 += 4) {
        const long long row = q * p.MP + m * p.P + p0;
        float ddx[4], ddy[4], a[4];
        load_points<VEC>(dx + row, p.P - p0, ddx);
        load_points<VEC>(dy + row, p.P - p0, ddy);
        load_points<VEC>(aw + row, p.P - p0, a);
        tap_weight(ddx, ddy, a, ty, tx, reach, w);
      }
      float gc[DT];
      load_channels<T, DV>(g + q * p.MD + c0, gc);
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] += w * gc[d];
    }
  }

  // 4. the lanes' sums in a fixed butterfly
  for (int o = 1; o < L; o <<= 1) {
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], o);
  }
  if (!active || lane != 0) return;
  store_sums<T, DV>(dv + ((static_cast<long long>(b) * p.Hl + py) * p.Wl + px) * p.MD + c0, acc);
}

// kSlices threads per (level pixel, head) on the vector path, per (level
// pixel, channel) on the scalar one: d v by walking every base cell within
// r and testing each sample of its queries (r > 5)
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
msda_bwd_walk_kernel(const float* __restrict__ dx, const float* __restrict__ dy,
                     const float* __restrict__ aw, const T* __restrict__ g,
                     T* __restrict__ dv, MsdaBwdParams p) {
  constexpr bool VEC = DV > 0;
  constexpr int DT = VEC ? DV : 1;  // channels of a thread
  const int units = VEC ? p.M : p.MD;  // jobs per level pixel
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long job = tid / kSlices;
  const int slice = static_cast<int>(tid % kSlices);
  // every lane stays to the shuffles; lanes past the last job sum nothing
  const bool active = job < static_cast<long long>(p.B) * p.Hl * p.Wl * units;
  float acc[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d] = 0.f;
  long long pix = 0;
  int c0 = 0;
  if (active) {
    const int unit = static_cast<int>(job % units);
    pix = job / units;
    const int px = static_cast<int>(pix % p.Wl);
    const int py = static_cast<int>((pix / p.Wl) % p.Hl);
    const int b = static_cast<int>(pix / (static_cast<long long>(p.Wl) * p.Hl));
    const int m = VEC ? unit : unit / p.D;
    c0 = VEC ? unit * DV : unit;  // first channel, m * D + d
    const float reach = static_cast<float>(p.r) + 1.f;
    // base cell rows py - r .. py + r (corner row ty = r .. -r), by slice;
    // a row of v off the level map (a tile's halo past the global edge)
    // holds no kept corner
    const int cy_end = py >= p.ylo && py < p.yhi ? 2 * p.r : -1;
    for (int cy = slice; cy <= cy_end; cy += kSlices) {
      const int by = py - p.r + cy, ty = p.r - cy;
      const int qy1 = first_query_row(by + 1, p);
      for (int qy = first_query_row(by, p); qy < qy1; ++qy) {
        const long long qrow = (static_cast<long long>(b) * p.Hq + qy) * p.Wq;
        for (int cx = 0; cx <= 2 * p.r; ++cx) {
          const int bx = px - p.r + cx, tx = p.r - cx;
          const int qx1 = first_query(bx + 1, p.f, p.Wq);
          for (int qx = first_query(bx, p.f, p.Wq); qx < qx1; ++qx) {
            const long long q = qrow + qx;
            const long long row = q * p.MP + m * p.P;
            // the query's weight on the pixel, summed over its samples
            float wq = 0.f;
            bool hit = false;
            for (int p0 = 0; p0 < p.P; p0 += 4) {
              float ddx[4], ddy[4];
              load_points<VEC>(dx + row + p0, p.P - p0, ddx);
              load_points<VEC>(dy + row + p0, p.P - p0, ddy);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (!(fabsf(ddx[u]) <= reach) || !(fabsf(ddy[u]) <= reach)) continue;
                const int y0 = static_cast<int>(floorf(ddy[u]));
                const int x0 = static_cast<int>(floorf(ddx[u]));
                if ((ty != y0 && ty != y0 + 1) || (tx != x0 && tx != x0 + 1)) continue;
                const float hy = fmaxf(0.f, 1.f - fabsf(ddy[u] - static_cast<float>(ty)));
                const float hx = fmaxf(0.f, 1.f - fabsf(ddx[u] - static_cast<float>(tx)));
                wq += aw[row + p0 + u] * hy * hx;
                hit = true;
              }
            }
            if (!hit) continue;
            const T* gq = g + q * p.MD + c0;
            if constexpr (VEC) {
              constexpr int V = 16 / sizeof(T);
#pragma unroll
              for (int k = 0; k < DV / V; ++k) {
                float c[V];
                load_vec16(gq + k * V, c);
#pragma unroll
                for (int e = 0; e < V; ++e) acc[k * V + e] += wq * c[e];
              }
            } else {
              acc[0] += wq * to_float(gq[0]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o < kSlices; o <<= 1) {
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], o);
  }
  if (!active || slice != 0) return;
  store_sums<T, DV>(dv + pix * p.MD + c0, acc);
}

inline unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// the 32-bit words of scratch the mask path takes: the query masks, and at
// f > 1 the cell masks behind them (ops/msda.py:msda_bwd_scratch_words)
inline long long mask_words(const MsdaBwdParams& p) {
  return static_cast<long long>(p.B) * p.M * kMaskWords * (p.qplane + (p.f > 1 ? p.cplane : 0));
}

template <typename T, int DV>
int launch_dv(const void* v, const void* dx, const void* dy, const void* aw, const void* g,
              void* dv, void* gdx, void* gdy, void* gaw, void* scratch, long long scratch_bytes,
              MsdaBwdParams p, cudaStream_t stream, int* variant) {
  const float* fdx = static_cast<const float*>(dx);
  const float* fdy = static_cast<const float*>(dy);
  const float* faw = static_cast<const float*>(aw);
  const T* tg = static_cast<const T*>(g);
  const bool masks = p.r <= kMaskRadius && p.f * p.f <= kSlotsPerLane * 32;
  *variant = (DV > 0 ? 1 : 0) | (masks ? 2 : 0);
  const unsigned sample_blocks = blocks_for(static_cast<long long>(p.nq) * p.M);
  const long long jobs = static_cast<long long>(p.B) * p.Hl * p.Wl * (DV > 0 ? p.M : p.MD);
  if (!masks) {
    msda_bwd_sample_kernel<T, DV, 0><<<sample_blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(v), fdx, fdy, faw, tg, static_cast<float*>(gdx),
        static_cast<float*>(gdy), static_cast<float*>(gaw), nullptr, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    msda_bwd_walk_kernel<T, DV><<<blocks_for(jobs * kSlices), kThreads, 0, stream>>>(
        fdx, fdy, faw, tg, static_cast<T*>(dv), p);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch_bytes < mask_words(p) * static_cast<long long>(sizeof(uint32_t)))
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* qmask = static_cast<uint32_t*>(scratch);
  uint32_t* cmask = p.f > 1 ? qmask + static_cast<long long>(p.B) * p.M * kMaskWords * p.qplane
                            : qmask;
  msda_bwd_sample_kernel<T, DV, 1><<<sample_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(v), fdx, fdy, faw, tg, static_cast<float*>(gdx),
      static_cast<float*>(gdy), static_cast<float*>(gaw), qmask, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.f > 1) {
    msda_bwd_cell_mask_kernel<<<blocks_for(static_cast<long long>(p.B) * p.M * kMaskWords *
                                           p.cplane),
                                kThreads, 0, stream>>>(qmask, cmask, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tile_bits = __builtin_ctz(static_cast<unsigned>(kThreads / p.lanes));
  p.txb = (tile_bits + 1) / 2;
  p.tyb = tile_bits / 2;
  p.tiles_x = (p.Wl + (1 << p.txb) - 1) >> p.txb;
  p.tiles_y = (p.Hl + (1 << p.tyb) - 1) >> p.tyb;
  const long long tiles = static_cast<long long>(p.B) * p.M * (DV > 0 ? 1 : p.D) * p.tiles_x *
                          p.tiles_y;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  msda_bwd_gather_kernel<T, DV><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      fdx, fdy, faw, tg, qmask, cmask, static_cast<T*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* v, const void* dx, const void* dy, const void* aw, const void* g,
           void* dv, void* gdx, void* gdy, void* gaw, void* scratch, long long scratch_bytes,
           MsdaBwdParams p, cudaStream_t stream, int* variant) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dx) |
      reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(aw) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dv) |
      reinterpret_cast<uintptr_t>(gdx) | reinterpret_cast<uintptr_t>(gdy) |
      reinterpret_cast<uintptr_t>(gaw);
  if (p.P % 4 == 0 && (addr & 15) == 0) {
    if (p.D == 8)
      return launch_dv<T, 8>(v, dx, dy, aw, g, dv, gdx, gdy, gaw, scratch, scratch_bytes, p,
                             stream, variant);
    if (p.D == 16)
      return launch_dv<T, 16>(v, dx, dy, aw, g, dv, gdx, gdy, gaw, scratch, scratch_bytes, p,
                              stream, variant);
  }
  return launch_dv<T, 0>(v, dx, dy, aw, g, dv, gdx, gdy, gaw, scratch, scratch_bytes, p, stream,
                         variant);
}

}  // namespace nmrf

extern "C" int nmrf_msda_taps_bwd(const void* v, const void* dx, const void* dy, const void* aw,
                                  const void* g, void* dv, void* gdx, void* gdy, void* gaw,
                                  void* scratch, long long scratch_bytes, int dtype, int B,
                                  int Hl, int Wl, int Hq, int Wq, int M, int D, int P,
                                  int radius, int qy0, int vy0, int Hg, void* stream,
                                  int* variant) {
  using namespace nmrf;
  MsdaBwdParams p;
  p.B = B; p.Hl = Hl; p.Wl = Wl; p.Hq = Hq; p.Wq = Wq;
  p.M = M; p.D = D; p.P = P; p.r = radius;
  p.f = Wl > 0 ? Wq / Wl : 0; p.MD = M * D; p.MP = M * P; p.nq = B * Hq * Wq;
  p.qy0 = qy0; p.vy0 = vy0;
  p.ylo = vy0 < 0 ? -vy0 : 0;
  p.yhi = Hg - vy0 < Hl ? Hg - vy0 : Hl;
  if (p.f < 1 || p.f * Wl != Wq || qy0 < 0 || qy0 + Hq > Hg * p.f || Hq < 1 || radius < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.taps = (2 * radius + 1) * (2 * radius + 1);
  // the base cells of the query rows, as rows of v: on the whole map -1 ..
  // Hl - 1 at f > 1 and 0 .. Hl - 1 at f 1 (a cell is its query)
  const int cell0 = (2 * qy0 + 1 + p.f) / (2 * p.f) - 1 - vy0;
  const int cell1 = (2 * (qy0 + Hq - 1) + 1 + p.f) / (2 * p.f) - 1 - vy0;
  p.oy = -cell0;
  p.ox = p.f > 1 ? 1 : 0;
  p.Hc = cell1 - cell0 + 1; p.Wc = Wl + p.ox;
  p.lanes = 1;
  while (p.lanes < 32 && 2 * p.lanes <= p.f * p.f) p.lanes *= 2;
  p.slots = (p.f * p.f + p.lanes - 1) / p.lanes;
  p.sdiv = (65536 + 2 * radius) / (2 * radius + 1);
  p.fdiv = (65536 + p.f - 1) / p.f;
  p.qplane = static_cast<long long>(Hq) * Wq;
  p.cplane = static_cast<long long>(p.Hc) * p.Wc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(v, dx, dy, aw, g, dv, gdx, gdy, gaw, scratch, scratch_bytes, p, s,
                         variant);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(v, dx, dy, aw, g, dv, gdx, gdy, gaw, scratch, scratch_bytes,
                                 p, s, variant);
  return static_cast<int>(cudaErrorInvalidValue);
}
