// Backward of the CSWin stripe attention (K2b).
//
// Replaces nmrf_tpu/ops/pallas/attention.py:_stripe_bwd_kernel, driven by
// _stripe_bwd_core / the VJP _sa_bwd.
//
// Function, per stripe and head, with the forward of stripe_attention.cu
// (P = softmax_j(scale q_i.k_j + mask_ij), out_i = sum_j P_ij v_j) and
// g = dL/dout:
//   D_i   = g_i.out_i = sum_j P_ij (g_i.v_j)
//   dS_ij = P_ij (g_i.v_j - D_i)
//   dq_i  = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i,
//   dv_j  = sum_i P_ij g_i.
// The anti-same-pixel mask (-1e9 between different candidates of one
// pixel) gives P_ij = 0 exactly; masked pairs are skipped.
//
// Design: the flash-attention-2 split, so the T x T logits of a stripe
// (T = 624 at KITTI size, 1.5 MB in f32 per head) never exist.
//   Kernel 1, one block of 64 threads per (64-query tile, stripe, head),
//   one query row per thread: a first pass over 64-key tiles in shared
//   memory is K2's online softmax (running max, sum and f32 output
//   accumulator); it gives the row's log-sum-exp and D_i = g_i.out_i in
//   f32, both kept in a [stripes, h, T] f32 buffer.  A second pass over the
//   same key tiles recomputes P_ij = exp(logit - lse_i) and accumulates dq_i
//   in registers.
//   Kernel 2, one block of 64 threads per (64-key tile, stripe, head), one
//   key row per thread with k_j, v_j, dk_j and dv_j in registers: query
//   rows, g rows and their lse and D stream through shared memory 64 at a
//   time.  Every output row is written once by one thread, so there are no
//   atomics and the result is deterministic.
// Inputs and outputs stay in the padded image layout [B, Hp, Wp, N, C].
//
// Bound on the H100 (bf16, training shape 48x96, batch 8): about 2.5x the
// forward's matrix work against reading q, k, v, g and writing dq, dk, dv
// once; this version does its dot products on CUDA cores in f32 (and the
// forward once more, for lse and D), so FMA issue bounds it.

#include "common.cuh"

namespace nmrf {

struct StripeBwdParams {
  int B, Hp, Wp, N, C, heads, H_sp, W_sp, ni, nj, T;
  float scale;
};

constexpr int kBwdTile = 64;

__device__ __forceinline__ long long stripe_offset(const StripeBwdParams& p, int stripe,
                                                   int head, int hd, int t) {
  const int b = stripe / (p.ni * p.nj);
  const int si = (stripe / p.nj) % p.ni, sj = stripe % p.nj;
  const int WN = p.W_sp * p.N;
  const int y = si * p.H_sp + t / WN;
  const int x = sj * p.W_sp + (t / p.N) % p.W_sp;
  return (((static_cast<long long>(b) * p.Hp + y) * p.Wp + x) * p.N + t % p.N) * p.C +
         head * hd;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdTile)
stripe_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ lse_out,
                     float* __restrict__ d_out, StripeBwdParams p) {
  __shared__ float sk[kBwdTile][HD + 1];
  __shared__ float sv[kBwdTile][HD + 1];
  const int stripe = blockIdx.y, head = blockIdx.z;
  const int i = blockIdx.x * kBwdTile + threadIdx.x;
  const bool active = i < p.T;
  const int pix_i = i / p.N;
  float qr[HD], gi[HD], acc[HD];
  if (active) {
    const long long off = stripe_offset(p, stripe, head, HD, i);
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      qr[c] = to_float(q[off + c]) * p.scale;
      gi[c] = to_float(g[off + c]);
    }
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  // pass 1: online softmax and output (K2's loop) -> lse_i, D_i
  for (int j0 = 0; j0 < p.T; j0 += kBwdTile) {
    const int nk = min(kBwdTile, p.T - j0);
    for (int idx = threadIdx.x; idx < nk * HD; idx += kBwdTile) {
      const int jj = idx / HD, c = idx % HD;
      const long long off = stripe_offset(p, stripe, head, HD, j0 + jj) + c;
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
  float lse = 0.f, D = 0.f;
  if (active) {
    lse = m + logf(l);
#pragma unroll
    for (int c = 0; c < HD; ++c) D += gi[c] * acc[c];
    D /= l;
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;  // now dq

  // pass 2: dS and dq
  for (int j0 = 0; j0 < p.T; j0 += kBwdTile) {
    const int nk = min(kBwdTile, p.T - j0);
    for (int idx = threadIdx.x; idx < nk * HD; idx += kBwdTile) {
      const int jj = idx / HD, c = idx % HD;
      const long long off = stripe_offset(p, stripe, head, HD, j0 + jj) + c;
      sk[jj][c] = to_float(k[off]);
      sv[jj][c] = to_float(v[off]);
    }
    __syncthreads();
    if (active) {
      for (int jj = 0; jj < nk; ++jj) {
        const int j = j0 + jj;
        if (j / p.N == pix_i && j != i) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          s += qr[c] * sk[jj][c];
          dp += gi[c] * sv[jj][c];
        }
        const float ds = expf(s - lse) * (dp - D);
#pragma unroll
        for (int c = 0; c < HD; ++c) acc[c] += ds * sk[jj][c];
      }
    }
    __syncthreads();
  }
  if (active) {
    const long long off = stripe_offset(p, stripe, head, HD, i);
#pragma unroll
    for (int c = 0; c < HD; ++c) dq[off + c] = from_float<T>(acc[c] * p.scale);
    const long long row = (static_cast<long long>(stripe) * p.heads + head) * p.T + i;
    lse_out[row] = lse;
    d_out[row] = D;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdTile)
stripe_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, const float* __restrict__ lse_in,
                      const float* __restrict__ d_in, T* __restrict__ dk, T* __restrict__ dv,
                      StripeBwdParams p) {
  __shared__ float sq[kBwdTile][HD + 1];
  __shared__ float sg[kBwdTile][HD + 1];
  __shared__ float slse[kBwdTile];
  __shared__ float sD[kBwdTile];
  const int stripe = blockIdx.y, head = blockIdx.z;
  const int j = blockIdx.x * kBwdTile + threadIdx.x;
  const bool active = j < p.T;
  const int pix_j = j / p.N;
  float kj[HD], vj[HD], dkj[HD], dvj[HD];
  if (active) {
    const long long off = stripe_offset(p, stripe, head, HD, j);
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      kj[c] = to_float(k[off + c]);
      vj[c] = to_float(v[off + c]);
    }
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) dkj[c] = dvj[c] = 0.f;
  const long long row0 = (static_cast<long long>(stripe) * p.heads + head) * p.T;

  for (int i0 = 0; i0 < p.T; i0 += kBwdTile) {
    const int nq = min(kBwdTile, p.T - i0);
    for (int idx = threadIdx.x; idx < nq * HD; idx += kBwdTile) {
      const int ii = idx / HD, c = idx % HD;
      const long long off = stripe_offset(p, stripe, head, HD, i0 + ii) + c;
      sq[ii][c] = to_float(q[off]) * p.scale;
      sg[ii][c] = to_float(g[off]);
    }
    if (threadIdx.x < nq) {
      slse[threadIdx.x] = lse_in[row0 + i0 + threadIdx.x];
      sD[threadIdx.x] = d_in[row0 + i0 + threadIdx.x];
    }
    __syncthreads();
    if (active) {
      for (int ii = 0; ii < nq; ++ii) {
        const int i = i0 + ii;
        if (i / p.N == pix_j && i != j) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          s += sq[ii][c] * kj[c];
          dp += sg[ii][c] * vj[c];
        }
        const float pr = expf(s - slse[ii]);
        const float ds = pr * (dp - sD[ii]);
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          dkj[c] += ds * sq[ii][c];  // q pre-scaled: dk = scale sum_i dS q_i
          dvj[c] += pr * sg[ii][c];
        }
      }
    }
    __syncthreads();
  }
  if (active) {
    const long long off = stripe_offset(p, stripe, head, HD, j);
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      dk[off + c] = from_float<T>(dkj[c]);
      dv[off + c] = from_float<T>(dvj[c]);
    }
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, float* lse, float* dsum, StripeBwdParams p, cudaStream_t stream) {
  dim3 grid((p.T + kBwdTile - 1) / kBwdTile, p.B * p.ni * p.nj, p.heads);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(g);
  stripe_bwd_dq_kernel<T, HD><<<grid, kBwdTile, 0, stream>>>(
      q_, k_, v_, g_, static_cast<T*>(dq), lse, dsum, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stripe_bwd_dkv_kernel<T, HD><<<grid, kBwdTile, 0, stream>>>(
      q_, k_, v_, g_, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(int hd, const void* q, const void* k, const void* v, const void* g, void* dq,
                 void* dk, void* dv, float* lse, float* dsum, StripeBwdParams p,
                 cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(q, k, v, g, dq, dk, dv, lse, dsum, p, s);
    case 32: return launch_bwd<T, 32>(q, k, v, g, dq, dk, dv, lse, dsum, p, s);
    case 64: return launch_bwd<T, 64>(q, k, v, g, dq, dk, dv, lse, dsum, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nmrf

extern "C" int nmrf_stripe_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* g, void* dq, void* dk, void* dv,
                                         void* lse, void* dsum, int dtype, int B, int Hp,
                                         int Wp, int N, int C, int heads, int H_sp, int W_sp,
                                         float scale, void* stream) {
  using namespace nmrf;
  StripeBwdParams p;
  p.B = B; p.Hp = Hp; p.Wp = Wp; p.N = N; p.C = C; p.heads = heads;
  p.H_sp = H_sp; p.W_sp = W_sp; p.ni = Hp / H_sp; p.nj = Wp / W_sp;
  p.T = H_sp * W_sp * N; p.scale = scale;
  const int hd = C / heads;
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(dsum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_bwd<float>(hd, q, k, v, g, dq, dk, dv, l, d, p, s);
  if (dtype == kBF16) return dispatch_bwd<__nv_bfloat16>(hd, q, k, v, g, dq, dk, dv, l, d, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
