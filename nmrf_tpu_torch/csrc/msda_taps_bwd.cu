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
// Design: two kernels and no float atomics, so two launches give the same
// bits.
//   * The sample kernel: one thread per (query, head), as B5's vector kernel.
//     It loads its head's D channels of g once, gathers each kept corner's D
//     channels of v and writes d dx, d dy and d aw of its P samples.
//   * The value kernel gathers instead of scattering.  kSlices consecutive
//     threads share one (level pixel, head).  They walk the base cells
//     within r of the pixel, a slice taking every kSlices-th row of cells.
//     A base cell's queries form one range per axis (base(q) =
//     floor((2q + 1 + f) / 2f) - 1 rises with q), so each cell is a block of
//     at most f x f queries, and each of their P samples is tested for a
//     corner on the pixel.  A query with a hit adds its samples' summed
//     weight times its head's g (the plain version's order) to D f32 sums
//     in registers, and the slices' sums meet in a fixed butterfly of
//     shuffles.  That is (2r+1)^2 tests per sample (about 1.1e9 a level at
//     the training shapes), nearly all of them misses: simple, and bound by
//     those tests rather than by bytes.
// The vector path (D 8 or 16, P a multiple of 4, every pointer 16-byte
// aligned: the swin neck's M 8, P 4, D 8) moves channels and samples in
// 16-byte vectors; otherwise the same kernels run on scalars, with one
// channel per thread in the value kernel.
//
// Bound on the H100 (bf16, one extractor of the swin training step: batch 16,
// the left and right images of 8 pairs, query grid 96 x 192, M 8, P 4, D 8):
// bytes.  dx, dy and aw read and their gradients written are 226 MB (f32),
// g 38 MB, v and d v 75 MB at f 1 down to 1.2 MB at f 8: 0.08-0.10 ms at
// 3.35 TB/s (chip_smoke.py:msda_bwd_bound).

#include "common.cuh"

namespace nmrf {

struct MsdaBwdParams {
  int B, Hl, Wl, Hq, Wq, M, D, P, r, f, MD, MP, nq;
};

constexpr int kThreads = 256;
constexpr int kSlices = 4;  // threads per (level pixel, head) in the value kernel

// the base cell of query coordinate q at level factor f
__device__ __forceinline__ int base_cell(int q, int f) { return (2 * q + 1 + f) / (2 * f) - 1; }

// the first query coordinate in [0, n] whose base cell is at least b
__device__ __forceinline__ int first_query(int b, int f, int n) {
  const int num = 2 * f * (b + 1) - 1 - f;
  return num <= 0 ? 0 : min((num + 1) / 2, n);
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

// one thread per (query, head): d dx, d dy and d aw of the head's P samples
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
msda_bwd_sample_kernel(const T* __restrict__ v, const float* __restrict__ dx,
                       const float* __restrict__ dy, const float* __restrict__ aw,
                       const T* __restrict__ g, float* __restrict__ gdx,
                       float* __restrict__ gdy, float* __restrict__ gaw, MsdaBwdParams p) {
  constexpr bool VEC = DV > 0;
  constexpr int V = 16 / sizeof(T);
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(p.nq) * p.M) return;
  const int q = static_cast<int>(idx / p.M), m = static_cast<int>(idx % p.M);
  const int qx = q % p.Wq;
  const int qy = (q / p.Wq) % p.Hq;
  const int b = q / (p.Wq * p.Hq);
  const int base_y = base_cell(qy, p.f), base_x = base_cell(qx, p.f);
  const T* vb = v + static_cast<long long>(b) * p.Hl * p.Wl * p.MD + m * p.D;
  const T* gq = g + static_cast<long long>(q) * p.MD + m * p.D;
  const long long row = static_cast<long long>(q) * p.MP + m * p.P;
  float gv[VEC ? DV : 1];
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < DV / V; ++k) load_vec16(gq + k * V, gv + k * V);
  }
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
        if (ty < -p.r || ty > p.r || ly < 0 || ly >= p.Hl) continue;
        const float zy = ddy[u] - static_cast<float>(ty);
        const float hy = fmaxf(0.f, 1.f - fabsf(zy));
        const float sy = hat_slope(zy);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int tx = x0 + j;
          const int lx = base_x + tx;
          if (tx < -p.r || tx > p.r || lx < 0 || lx >= p.Wl) continue;
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
}

// kSlices threads per (level pixel, head) on the vector path, per (level
// pixel, channel) on the scalar one: d v, gathered in a fixed order
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
msda_bwd_value_kernel(const float* __restrict__ dx, const float* __restrict__ dy,
                      const float* __restrict__ aw, const T* __restrict__ g,
                      T* __restrict__ dv, MsdaBwdParams p) {
  constexpr bool VEC = DV > 0;
  constexpr int DT = VEC ? DV : 1;  // channels of a thread
  constexpr int V = 16 / sizeof(T);
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
    // base cell rows py - r .. py + r (corner row ty = r .. -r), by slice
    for (int cy = slice; cy <= 2 * p.r; cy += kSlices) {
      const int by = py - p.r + cy, ty = p.r - cy;
      const int qy1 = first_query(by + 1, p.f, p.Hq);
      for (int qy = first_query(by, p.f, p.Hq); qy < qy1; ++qy) {
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
  T* dst = dv + pix * p.MD + c0;
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < DV / V; ++k) store_vec16(dst + k * V, acc + k * V);
  } else {
    dst[0] = from_float<T>(acc[0]);
  }
}

inline unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename T, int DV>
int launch_dv(const void* v, const void* dx, const void* dy, const void* aw, const void* g,
              void* dv, void* gdx, void* gdy, void* gaw, MsdaBwdParams p, cudaStream_t stream) {
  const float* fdx = static_cast<const float*>(dx);
  const float* fdy = static_cast<const float*>(dy);
  const float* faw = static_cast<const float*>(aw);
  const T* tg = static_cast<const T*>(g);
  msda_bwd_sample_kernel<T, DV><<<blocks_for(static_cast<long long>(p.nq) * p.M), kThreads, 0,
                                   stream>>>(static_cast<const T*>(v), fdx, fdy, faw, tg,
                                             static_cast<float*>(gdx), static_cast<float*>(gdy),
                                             static_cast<float*>(gaw), p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long jobs = static_cast<long long>(p.B) * p.Hl * p.Wl * (DV > 0 ? p.M : p.MD);
  msda_bwd_value_kernel<T, DV><<<blocks_for(jobs * kSlices), kThreads, 0, stream>>>(
      fdx, fdy, faw, tg, static_cast<T*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* v, const void* dx, const void* dy, const void* aw, const void* g,
           void* dv, void* gdx, void* gdy, void* gaw, MsdaBwdParams p, cudaStream_t stream) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dx) |
      reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(aw) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dv) |
      reinterpret_cast<uintptr_t>(gdx) | reinterpret_cast<uintptr_t>(gdy) |
      reinterpret_cast<uintptr_t>(gaw);
  if (p.P % 4 == 0 && (addr & 15) == 0) {
    if (p.D == 8) return launch_dv<T, 8>(v, dx, dy, aw, g, dv, gdx, gdy, gaw, p, stream);
    if (p.D == 16) return launch_dv<T, 16>(v, dx, dy, aw, g, dv, gdx, gdy, gaw, p, stream);
  }
  return launch_dv<T, 0>(v, dx, dy, aw, g, dv, gdx, gdy, gaw, p, stream);
}

}  // namespace nmrf

extern "C" int nmrf_msda_taps_bwd(const void* v, const void* dx, const void* dy, const void* aw,
                                  const void* g, void* dv, void* gdx, void* gdy, void* gaw,
                                  int dtype, int B, int Hl, int Wl, int Hq, int Wq, int M, int D,
                                  int P, int radius, void* stream) {
  using namespace nmrf;
  MsdaBwdParams p;
  p.B = B; p.Hl = Hl; p.Wl = Wl; p.Hq = Hq; p.Wq = Wq;
  p.M = M; p.D = D; p.P = P; p.r = radius;
  p.f = Hl > 0 ? Hq / Hl : 0; p.MD = M * D; p.MP = M * P; p.nq = B * Hq * Wq;
  if (p.f < 1 || p.f * Hl != Hq || p.f * Wl != Wq || radius < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(v, dx, dy, aw, g, dv, gdx, gdy, gaw, p, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(v, dx, dy, aw, g, dv, gdx, gdy, gaw, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
