// Rectangular masked attention (B6).
//
// Replaces nmrf_tpu/ops/pallas/attention.py:_masked_attention_kernel, driven
// by masked_attention / masked_attention_op.
//
// Function, per group g and head h, for Rq query rows and Rk key rows:
//   out_i = sum_j softmax_j(scale q_i.k_j + mask[g % Gm, i, j]) v_j
// with an explicit additive f32 mask (Gm = 1 broadcasts one mask over the
// groups).  Rq differs from Rk on its one path: under H-sharding the CSWin
// vertical stripe spans the global H, so the local query rows of a tile
// attend to the all-gathered stripe (Rq = H8_loc*N, Rk = H8*N).
// Layouts: q [h, G, Rq, hd], k and v [h, G, Rk, hd], mask [Gm, Rq, Rk] f32,
// out [h, G, Rq, hd] in q's dtype.
//
// Design: one block of 64 threads per (64-query tile, group, head), one
// query row per thread with its scaled q and the output accumulator in
// registers.  Key and value rows stream through shared memory 32 at a time,
// with the [64 x 32] tile of the mask beside them (read row by row, so the
// loads are coalesced; the row stride is odd in words, so each thread reads
// its own row free of bank conflicts).  An online softmax keeps the running
// max and sum in f32, so the Rq x Rk logits never exist.  Softmax and every
// sum are f32, for f32 and bf16 inputs alike.
//
// Bound on the H100 (bf16, training shape 384x768 on 2 tiles, batch 8:
// Rq 96, Rk 192, G 768, 2 heads, hd 32): q, k, v read and the output written
// once (about 57 MB) and 2 x 2 x Rq x Rk x hd flops per (group, head), about
// 3.6 GFLOP; the bytes bound it (about 17 us).  This version does its dot
// products on CUDA cores in f32, so FMA issue bounds it far above that;
// mma/wgmma tiles are the next step.

#include "common.cuh"

namespace nmrf {

struct MaskedParams {
  int G, Gm, heads, Rq, Rk;
  float scale;
};

constexpr int kMaQTile = 64;
constexpr int kMaKTile = 32;

template <typename T, int HD>
__global__ void __launch_bounds__(kMaQTile)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ mask,
                        T* __restrict__ out, MaskedParams p) {
  __shared__ float sk[kMaKTile][HD + 1];
  __shared__ float sv[kMaKTile][HD + 1];
  __shared__ float sm[kMaQTile][kMaKTile + 1];
  const int g = blockIdx.y, head = blockIdx.z;
  const int q0 = blockIdx.x * kMaQTile;
  const int i = q0 + threadIdx.x;
  const bool active = i < p.Rq;
  const long long gh = static_cast<long long>(head) * p.G + g;
  const T* qb = q + gh * p.Rq * HD;
  const T* kb = k + gh * p.Rk * HD;
  const T* vb = v + gh * p.Rk * HD;
  const float* mb = mask + static_cast<long long>(g % p.Gm) * p.Rq * p.Rk;

  float qr[HD], acc[HD];
  if (active) {
#pragma unroll
    for (int c = 0; c < HD; ++c) qr[c] = to_float(qb[static_cast<long long>(i) * HD + c]) * p.scale;
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < p.Rk; j0 += kMaKTile) {
    const int nk = min(kMaKTile, p.Rk - j0);
    for (int idx = threadIdx.x; idx < nk * HD; idx += kMaQTile) {
      const int jj = idx / HD, c = idx % HD;
      const long long off = static_cast<long long>(j0 + jj) * HD + c;
      sk[jj][c] = to_float(kb[off]);
      sv[jj][c] = to_float(vb[off]);
    }
    for (int idx = threadIdx.x; idx < kMaQTile * kMaKTile; idx += kMaQTile) {
      const int ii = idx / kMaKTile, jj = idx % kMaKTile;
      sm[ii][jj] = (q0 + ii < p.Rq && jj < nk)
                       ? mb[static_cast<long long>(q0 + ii) * p.Rk + j0 + jj]
                       : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int jj = 0; jj < nk; ++jj) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) s += qr[c] * sk[jj][c];
        s += sm[threadIdx.x][jj];
        if (s > m) {
          const float corr = expf(m - s);
          l *= corr;
#pragma unroll
          for (int c = 0; c < HD; ++c) acc[c] *= corr;
          m = s;
        }
        const float e = expf(s - m);
        l += e;
#pragma unroll
        for (int c = 0; c < HD; ++c) acc[c] += e * sv[jj][c];
      }
    }
    __syncthreads();
  }
  if (active) {
    T* o = out + (gh * p.Rq + i) * HD;
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] = from_float<T>(acc[c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const float* mask, void* out,
           MaskedParams p, cudaStream_t stream) {
  dim3 grid((p.Rq + kMaQTile - 1) / kMaQTile, p.G, p.heads);
  masked_attention_kernel<T, HD><<<grid, kMaQTile, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const float* mask,
                void* out, MaskedParams p, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, mask, out, p, s);
    case 32: return launch<T, 32>(q, k, v, mask, out, p, s);
    case 64: return launch<T, 64>(q, k, v, mask, out, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nmrf

extern "C" int nmrf_masked_attention(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int dtype, int G, int Gm,
                                     int heads, int Rq, int Rk, int hd, float scale,
                                     void* stream) {
  using namespace nmrf;
  if (G <= 0 || Gm <= 0 || heads <= 0 || Rq <= 0 || Rk <= 0 || G > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  MaskedParams p;
  p.G = G; p.Gm = Gm; p.heads = heads; p.Rq = Rq; p.Rk = Rk; p.scale = scale;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_hd<float>(hd, q, k, v, m, out, p, s);
  if (dtype == kBF16) return dispatch_hd<__nv_bfloat16>(hd, q, k, v, m, out, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
