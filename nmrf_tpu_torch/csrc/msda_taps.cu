// Tap-based multi-scale deformable attention of one level (kernel B5).
//
// Replaces nmrf_tpu/ops/pallas/msda.py:_msda_tap_kernel, driven by
// msda_taps_level.
//
// Function: the queries form a regular Hq x Wq grid over a level map of
// Hl x Wl pixels, f = Hq / Hl = Wq / Wl.  Query q has the base cell
// base(q) = floor((2q + 1 + f) / (2f)) - 1 per axis, and head m samples P
// points at base + (dy, dx) (level pixels, f32) with weights aw:
//   out[q, m*D + d] = sum_p aw[q,m,p] * sum over the bilinear corners
//       (ty, tx) in {floor(dy), floor(dy)+1} x {floor(dx), floor(dx)+1}
//       of hat(dy - ty) * hat(dx - tx) * v[base_y + ty, base_x + tx, m*D + d],
//   hat(z) = max(0, 1 - |z|).
// A corner outside the level map reads zero, and a corner with |ty| > r or
// |tx| > r is dropped: exactly the terms that the JAX package's dense
// (2r+1)^2-tap hat sum keeps.
//
// On an H tile (the swin neck under a spatial group) the Hq query rows are
// global rows qy0 .. qy0 + Hq - 1 of the grid and the Hl rows of v are
// global level rows vy0 .. vy0 + Hl - 1 of the level's Hg, holding at
// least the rows those queries reach (the caller's halo): base cells, dy
// and the map's edges are global.  f is Wq / Wl (W is never split).  The
// entry hands the kernels v's rows on the level map alone (its pointer
// moved to the first, their count as the kernels' Hl, their first global
// row as vy0), so the kernels' corner test is the whole map's; qy0 = vy0
// = 0 and Hg = Hl with Hq = f Hl is the whole map, the same arithmetic and
// bits as before the offsets.
//
// Design: the TPU kernel walks all (2r+1)^2 taps because the TPU has no
// vector gather; here every thread gathers the 4 corners of its samples
// directly, as upstream's CUDA im2col does.  Two kernels, chosen by shape:
//   * the vector kernel, when a head's D channels are 8 or 16 (a whole
//     number of 16-byte vectors in either dtype), P is a multiple of 4 and
//     every pointer is 16-byte aligned (the swin neck: M 8, P 4, D 8).  One thread per (query, head), consecutive
//     threads on consecutive heads of a query: it reads its head's P
//     displacements and weights with 16-byte loads straight from the
//     [.., M*P] f32 rows (contiguous per head, so a warp reads 512
//     contiguous bytes of each), gathers each bilinear corner's D channels
//     with one 16-byte load (two for f32 at D 8), keeps D f32 sums in
//     registers and writes them with one 16-byte store;
//   * otherwise the scalar kernel: one block per kQ consecutive query
//     pixels, one thread per (query, output channel), blockDim = (M*D,
//     kQ); the block stages the dx/dy/aw rows of its queries in shared
//     memory with coalesced loads, and each thread walks its head's P
//     points, the D threads of a head reading D consecutive channels.
// Both sum points and corners in one order (point, corner row, corner
// column), with the same weights, in f32.  The entry reports which one it
// launched through ``variant``: 1 the vector kernel, 0 the scalar one.
//
// Bound on the H100 (bf16, one extractor of a swin KITTI request, batch 2,
// query grid 96 x 312, M 8, P 4, D 8): bytes.  dx/dy/aw are 23.0 MB (f32),
// v 7.7 MB at f 1 down to 0.12 MB at f 8, the output 7.7 MB: about 9-11 us
// at 3.35 TB/s.  The arithmetic (about 60 MFLOP) is negligible, and v is
// small enough to stay in the 50 MB L2 across the gathers.

#include <stdint.h>

#include "common.cuh"

namespace nmrf {

struct MsdaParams {
  int B, Hl, Wl, Hq, Wq, M, D, P, r, f, MD, MP, nq;
  int qy0, vy0;        // global rows of the first query row and of v's row 0
  long long vstride;   // elements of one image's v
};

// the row of v holding the base cell of local query row qy
__device__ __forceinline__ int base_row(int qy, const MsdaParams& p) {
  return (2 * (qy + p.qy0) + 1 + p.f) / (2 * p.f) - 1 - p.vy0;
}

template <typename T>
__global__ void msda_taps_kernel(const T* __restrict__ v, const float* __restrict__ dx,
                                 const float* __restrict__ dy, const float* __restrict__ aw,
                                 T* __restrict__ out, MsdaParams p) {
  extern __shared__ float smem[];  // [3][blockDim.y][MP]: dx, dy, aw rows
  const int kq = blockDim.y;
  const int q0 = blockIdx.x * kq;
  const int nq = min(kq, p.nq - q0);
  float* sdx = smem;
  float* sdy = sdx + kq * p.MP;
  float* saw = sdy + kq * p.MP;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const long long row0 = static_cast<long long>(q0) * p.MP;
  for (int i = tid; i < nq * p.MP; i += nthreads) {
    sdx[i] = dx[row0 + i];
    sdy[i] = dy[row0 + i];
    saw[i] = aw[row0 + i];
  }
  __syncthreads();
  const int qi = threadIdx.y;
  if (qi >= nq) return;
  const int q = q0 + qi;
  const int c = threadIdx.x;  // output channel, m * D + d
  const int m = c / p.D;
  const int qx = q % p.Wq;
  const int qy = (q / p.Wq) % p.Hq;
  const int b = q / (p.Wq * p.Hq);
  const int base_y = base_row(qy, p);
  const int base_x = (2 * qx + 1 + p.f) / (2 * p.f) - 1;
  const T* vb = v + static_cast<long long>(b) * p.vstride + c;
  const float reach = static_cast<float>(p.r) + 1.f;
  float acc = 0.f;
  for (int pt = 0; pt < p.P; ++pt) {
    const int k = qi * p.MP + m * p.P + pt;
    const float ddx = sdx[k], ddy = sdy[k], a = saw[k];
    // beyond r + 1 every corner is dropped (and the int cast stays in range)
    if (!(fabsf(ddx) <= reach) || !(fabsf(ddy) <= reach)) continue;
    const int y0 = static_cast<int>(floorf(ddy));
    const int x0 = static_cast<int>(floorf(ddx));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ty = y0 + i;
      const int ly = base_y + ty;
      if (ty < -p.r || ty > p.r || ly < 0 || ly >= p.Hl) continue;
      const float wy = a * fmaxf(0.f, 1.f - fabsf(ddy - static_cast<float>(ty)));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int tx = x0 + j;
        const int lx = base_x + tx;
        if (tx < -p.r || tx > p.r || lx < 0 || lx >= p.Wl) continue;
        const float w = wy * fmaxf(0.f, 1.f - fabsf(ddx - static_cast<float>(tx)));
        acc += w * to_float(vb[(static_cast<long long>(ly) * p.Wl + lx) * p.MD]);
      }
    }
  }
  out[static_cast<long long>(q) * p.MD + c] = from_float<T>(acc);
}

constexpr int kVecThreads = 256;
// blocks of the vector kernel an SM must hold at once: up to 85 registers
// a thread (its f32 D 16 form takes about 72); left to itself, ptxas held
// the bf16 D 8 form at 48 and spilled 8 bytes once the row offsets came in
constexpr int kVecMinBlocks = 3;

// one thread per (query, head); D channels, V = 16 / sizeof(T) per vector
template <typename T, int D>
__global__ void __launch_bounds__(kVecThreads, kVecMinBlocks)
msda_taps_vec_kernel(const T* __restrict__ v, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ aw,
                     T* __restrict__ out, MsdaParams p) {
  constexpr int V = 16 / sizeof(T);
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(p.nq) * p.M) return;
  const int q = static_cast<int>(idx / p.M), m = static_cast<int>(idx % p.M);
  const int qx = q % p.Wq;
  const int qy = (q / p.Wq) % p.Hq;
  const int b = q / (p.Wq * p.Hq);
  const int base_y = base_row(qy, p);
  const int base_x = (2 * qx + 1 + p.f) / (2 * p.f) - 1;
  const T* vb = v + static_cast<long long>(b) * p.vstride + m * D;
  const long long row = static_cast<long long>(q) * p.MP + m * p.P;
  const float reach = static_cast<float>(p.r) + 1.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int p0 = 0; p0 < p.P; p0 += 4) {
    float ddx[4], ddy[4], a[4];
    load_vec16(dx + row + p0, ddx);
    load_vec16(dy + row + p0, ddy);
    load_vec16(aw + row + p0, a);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // beyond r + 1 every corner is dropped (and the int cast stays in range)
      if (!(fabsf(ddx[u]) <= reach) || !(fabsf(ddy[u]) <= reach)) continue;
      const int y0 = static_cast<int>(floorf(ddy[u]));
      const int x0 = static_cast<int>(floorf(ddx[u]));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ty = y0 + i;
        const int ly = base_y + ty;
        if (ty < -p.r || ty > p.r || ly < 0 || ly >= p.Hl) continue;
        const float wy = a[u] * fmaxf(0.f, 1.f - fabsf(ddy[u] - static_cast<float>(ty)));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int tx = x0 + j;
          const int lx = base_x + tx;
          if (tx < -p.r || tx > p.r || lx < 0 || lx >= p.Wl) continue;
          const float w = wy * fmaxf(0.f, 1.f - fabsf(ddx[u] - static_cast<float>(tx)));
          const T* src = vb + (static_cast<long long>(ly) * p.Wl + lx) * p.MD;
#pragma unroll
          for (int k = 0; k < D / V; ++k) {
            float c[V];
            load_vec16(src + k * V, c);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[k * V + e] += w * c[e];
          }
        }
      }
    }
  }
  T* dst = out + static_cast<long long>(q) * p.MD + m * D;
#pragma unroll
  for (int k = 0; k < D / V; ++k) store_vec16(dst + k * V, acc + k * V);
}

template <typename T, int D>
int launch_vec(const void* v, const void* dx, const void* dy, const void* aw, void* out,
               MsdaParams p, cudaStream_t stream) {
  const long long threads = static_cast<long long>(p.nq) * p.M;
  const unsigned grid = static_cast<unsigned>((threads + kVecThreads - 1) / kVecThreads);
  msda_taps_vec_kernel<T, D><<<grid, kVecThreads, 0, stream>>>(
      static_cast<const T*>(v), static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const float*>(aw), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* v_all, const void* dx, const void* dy, const void* aw, void* out,
           MsdaParams p, int ylo, cudaStream_t stream, int* variant) {
  // v's rows on the level map start at its row ylo
  const void* v = static_cast<const T*>(v_all) + static_cast<long long>(ylo) * p.Wl * p.MD;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dx) |
                         reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(aw) |
                         reinterpret_cast<uintptr_t>(out);
  if (p.P % 4 == 0 && (addr & 15) == 0 && (p.D == 8 || p.D == 16)) {
    *variant = 1;
    if (p.D == 8) return launch_vec<T, 8>(v, dx, dy, aw, out, p, stream);
    return launch_vec<T, 16>(v, dx, dy, aw, out, p, stream);
  }
  *variant = 0;
  const int kq = p.MD >= 256 ? 1 : 256 / p.MD;
  const size_t smem = 3 * static_cast<size_t>(kq) * p.MP * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(p.MD, kq);
  dim3 grid((p.nq + kq - 1) / kq);
  msda_taps_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const float*>(aw), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmrf

extern "C" int nmrf_msda_taps(const void* v, const void* dx, const void* dy, const void* aw,
                              void* out, int dtype, int B, int Hl, int Wl, int Hq, int Wq,
                              int M, int D, int P, int radius, int qy0, int vy0,
                              int Hg, void* stream, int* variant) {
  using namespace nmrf;
  MsdaParams p;
  p.B = B; p.Wl = Wl; p.Hq = Hq; p.Wq = Wq;
  p.M = M; p.D = D; p.P = P; p.r = radius;
  p.f = Wl > 0 ? Wq / Wl : 0; p.MD = M * D; p.MP = M * P; p.nq = B * Hq * Wq;
  if (p.MD > 1024 || p.f < 1 || p.f * Wl != Wq || qy0 < 0 || qy0 + Hq > Hg * p.f)
    return static_cast<int>(cudaErrorInvalidValue);
  // v's rows on the level map: ylo .. yhi - 1
  const int ylo = vy0 < 0 ? -vy0 : 0;
  const int yhi = Hg - vy0 < Hl ? Hg - vy0 : Hl;
  p.Hl = yhi > ylo ? yhi - ylo : 0;
  p.qy0 = qy0;
  p.vy0 = vy0 + ylo;
  p.vstride = static_cast<long long>(Hl) * Wl * p.MD;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(v, dx, dy, aw, out, p, ylo, s, variant);
  if (dtype == kBF16) return launch<__nv_bfloat16>(v, dx, dy, aw, out, p, ylo, s, variant);
  return static_cast<int>(cudaErrorInvalidValue);
}
