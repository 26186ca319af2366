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
// Design: the TPU kernel walks all (2r+1)^2 taps because the TPU has no
// vector gather; here every thread gathers its 4 corners directly, as
// upstream's CUDA im2col does.  One block per kQ consecutive query pixels,
// one thread per (query, output channel): blockDim = (M*D, kQ).  The block
// stages the dx/dy/aw rows of its queries (contiguous in memory) in shared
// memory with coalesced loads; each thread then walks its head's P points
// and reads v channel-last, so the D threads of a head read D consecutive
// channels of one level pixel.  Sums in f32, one store per output channel.
//
// Bound on the H100 (bf16, one extractor of a swin KITTI request, batch 2,
// query grid 96 x 312, M 8, P 4, D 8): bytes.  dx/dy/aw are 23.0 MB (f32),
// v 7.7 MB at f 1 down to 0.12 MB at f 8, the output 7.7 MB: about 9-11 us
// at 3.35 TB/s.  The arithmetic (about 60 MFLOP) is negligible, and v is
// small enough to stay in the 50 MB L2 across the gathers.

#include "common.cuh"

namespace nmrf {

struct MsdaParams {
  int B, Hl, Wl, Hq, Wq, M, D, P, r, f, MD, MP, nq;
};

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
  const int base_y = (2 * qy + 1 + p.f) / (2 * p.f) - 1;
  const int base_x = (2 * qx + 1 + p.f) / (2 * p.f) - 1;
  const T* vb = v + static_cast<long long>(b) * p.Hl * p.Wl * p.MD + c;
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

template <typename T>
int launch(const void* v, const void* dx, const void* dy, const void* aw, void* out,
           MsdaParams p, cudaStream_t stream) {
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
                              int M, int D, int P, int radius, void* stream) {
  using namespace nmrf;
  MsdaParams p;
  p.B = B; p.Hl = Hl; p.Wl = Wl; p.Hq = Hq; p.Wq = Wq;
  p.M = M; p.D = D; p.P = P; p.r = radius;
  p.f = Hq / Hl; p.MD = M * D; p.MP = M * P; p.nq = B * Hq * Wq;
  if (p.MD > 1024 || p.f < 1 || p.f * Hl != Hq || p.f * Wl != Wq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(v, dx, dy, aw, out, p, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(v, dx, dy, aw, out, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
