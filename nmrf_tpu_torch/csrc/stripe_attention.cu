// CSWin stripe attention with the anti-same-pixel mask.
//
// Replaces nmrf_tpu/ops/pallas/attention.py:_stripe_attention_kernel, driven
// by stripe_attention_direct / _stripe_direct_core.
//
// Function, per stripe (H_sp x W_sp pixels x N candidates, tokens in
// (row, col, candidate) order) and head:
//   out_i = sum_j softmax_j(scale * q_i.k_j + mask_ij) v_j,
//   mask_ij = -1e9 where tokens i and j are different candidates of one pixel.
// Inputs and output stay in the padded image layout [B, Hp, Wp, N, C]; the
// kernel addresses every stripe in place, so the caller never packs stripes.
//
// Design: one block of 64 threads per (64-query tile, stripe, head), one
// query row per thread with q and the output accumulator in registers.  Key
// and value rows stream through shared memory 64 at a time (cooperative,
// channel-contiguous loads) and an online softmax keeps the running max and
// sum in f32, so the T x T logits (1.5 MB at T = 624) never exist.  A masked
// key is skipped, which equals adding -1e9: every row keeps its own token.
//
// Bound on the H100 (bf16, KITTI main path): 4.7 GFLOP (horizontal,
// T = 624) or 1.4 GFLOP (vertical, T = 188) per launch against about 15 MB
// of traffic; this version does the dot products on CUDA cores in f32, so
// FMA issue bounds it.  mma/wgmma tiles are the next step.

#include "common.cuh"

namespace nmrf {

struct StripeParams {
  int B, Hp, Wp, N, C, heads, H_sp, W_sp, ni, nj, T;
  float scale;
};

constexpr int kTile = 64;

template <typename T, int HD>
__global__ void __launch_bounds__(kTile)
stripe_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, StripeParams p) {
  __shared__ float sk[kTile][HD + 1];
  __shared__ float sv[kTile][HD + 1];
  const int stripe = blockIdx.y, head = blockIdx.z;
  const int b = stripe / (p.ni * p.nj);
  const int si = (stripe / p.nj) % p.ni, sj = stripe % p.nj;
  const int WN = p.W_sp * p.N;

  auto offset = [&](int t) -> long long {
    const int y = si * p.H_sp + t / WN;
    const int x = sj * p.W_sp + (t / p.N) % p.W_sp;
    return (((static_cast<long long>(b) * p.Hp + y) * p.Wp + x) * p.N + t % p.N) * p.C +
           head * HD;
  };

  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool active = i < p.T;
  float qr[HD], acc[HD];
  if (active) {
    const T* qi = q + offset(i);
#pragma unroll
    for (int c = 0; c < HD; ++c) qr[c] = to_float(qi[c]) * p.scale;
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int pix_i = i / p.N;

  for (int j0 = 0; j0 < p.T; j0 += kTile) {
    const int nk = min(kTile, p.T - j0);
    for (int idx = threadIdx.x; idx < nk * HD; idx += kTile) {
      const int jj = idx / HD, c = idx % HD;
      const long long off = offset(j0 + jj) + c;
      sk[jj][c] = to_float(k[off]);
      sv[jj][c] = to_float(v[off]);
    }
    __syncthreads();
    if (active) {
      for (int jj = 0; jj < nk; ++jj) {
        const int j = j0 + jj;
        if (j / p.N == pix_i && j != i) continue;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) s += qr[c] * sk[jj][c];
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
    T* o = out + offset(i);
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] = from_float<T>(acc[c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, StripeParams p,
           cudaStream_t stream) {
  dim3 grid((p.T + kTile - 1) / kTile, p.B * p.ni * p.nj, p.heads);
  stripe_attention_kernel<T, HD><<<grid, kTile, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out,
                StripeParams p, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, p, s);
    case 32: return launch<T, 32>(q, k, v, out, p, s);
    case 64: return launch<T, 64>(q, k, v, out, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nmrf

extern "C" int nmrf_stripe_attention(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int B, int Hp, int Wp, int N, int C,
                                     int heads, int H_sp, int W_sp, float scale,
                                     void* stream) {
  using namespace nmrf;
  StripeParams p;
  p.B = B; p.Hp = Hp; p.Wp = Wp; p.N = N; p.C = C; p.heads = heads;
  p.H_sp = H_sp; p.W_sp = W_sp; p.ni = Hp / H_sp; p.nj = Wp / W_sp;
  p.T = H_sp * W_sp * N; p.scale = scale;
  const int hd = C / heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_hd<float>(hd, q, k, v, out, p, s);
  if (dtype == kBF16) return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
