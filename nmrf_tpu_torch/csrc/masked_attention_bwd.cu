// Backward of the rectangular masked attention (B6b).
//
// Replaces nmrf_tpu/ops/pallas/attention.py:_masked_attention_bwd_kernel,
// driven by the VJP _ma_bwd of masked_attention_op.
//
// Function, per group and head, with the forward of masked_attention.cu
// (P = softmax_j(scale q_i.k_j + mask_ij) over the Rk keys, out_i =
// sum_j P_ij v_j) and g = dL/dout:
//   D_i   = g_i.out_i = sum_j P_ij (g_i.v_j)
//   dS_ij = P_ij (g_i.v_j - D_i)
//   dq_i  = scale sum_j dS_ij k_j,  dk_j = sum_i dS_ij (scale q_i),
//   dv_j  = sum_i P_ij g_i.
// The scale enters dq once and dk through the pre-scaled q, as at
// attention.py:152-155; the mask has no gradient.
//
// Design: the flash-attention-2 split of stripe_attention_bwd.cu, for
// Rq != Rk, so the Rq x Rk logits never exist.
//   Kernel 1, one block of 64 threads per (64-query tile, group, head), one
//   query row per thread: a first pass over 32-key tiles (keys, values and
//   the mask tile in shared memory) is B6's online softmax and gives the
//   row's log-sum-exp and D_i in f32, kept in [h, G, Rq] f32 buffers; a
//   second pass over the same tiles recomputes P_ij = exp(logit - lse_i) and
//   accumulates dq_i in registers.
//   Kernel 2, one block of 64 threads per (64-key tile, group, head), one key
//   row per thread with k_j, v_j, dk_j and dv_j in registers: it walks all Rq
//   query rows, 32 at a time, with their scaled q, g, lse, D and the [32 x
//   64] mask tile in shared memory.  Every output row is written once by one
//   thread: no atomics, deterministic.
// Softmax and every sum are f32, for f32 and bf16 inputs alike.
//
// Bound on the H100 (bf16, Rq 96, Rk 192, G 768, 2 heads, hd 32): q, k, v
// and g read and dq, dk, dv written once (about 104 MB) against 2.5x the
// forward's matrix work (about 9 GFLOP): the bytes bound it (about 31 us).
// This version recomputes the logits in both kernels on CUDA cores in f32,
// so FMA issue bounds it far above that.

#include "common.cuh"

namespace nmrf {

struct MaskedBwdParams {
  int G, Gm, heads, Rq, Rk;
  float scale;
};

constexpr int kMbTile = 64;   // rows owned by a block (queries or keys)
constexpr int kMbStream = 32; // rows streamed through shared memory at a time

template <typename T, int HD>
__global__ void __launch_bounds__(kMbTile)
masked_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, const T* __restrict__ g,
                     T* __restrict__ dq, float* __restrict__ lse_out, float* __restrict__ d_out,
                     MaskedBwdParams p) {
  __shared__ float sk[kMbStream][HD + 1];
  __shared__ float sv[kMbStream][HD + 1];
  __shared__ float sm[kMbTile][kMbStream + 1];
  const int grp = blockIdx.y, head = blockIdx.z;
  const int q0 = blockIdx.x * kMbTile;
  const int i = q0 + threadIdx.x;
  const bool active = i < p.Rq;
  const long long gh = static_cast<long long>(head) * p.G + grp;
  const T* kb = k + gh * p.Rk * HD;
  const T* vb = v + gh * p.Rk * HD;
  const float* mb = mask + static_cast<long long>(grp % p.Gm) * p.Rq * p.Rk;
  const long long qoff = (gh * p.Rq + i) * HD;

  float qr[HD], gi[HD], acc[HD];
  if (active) {
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      qr[c] = to_float(q[qoff + c]) * p.scale;
      gi[c] = to_float(g[qoff + c]);
    }
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f, lse = 0.f, D = 0.f;

  // pass 0: online softmax and output (B6's loop) -> lse_i, D_i;
  // pass 1: dS and dq
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < p.Rk; j0 += kMbStream) {
      const int nk = min(kMbStream, p.Rk - j0);
      for (int idx = threadIdx.x; idx < nk * HD; idx += kMbTile) {
        const int jj = idx / HD, c = idx % HD;
        const long long off = static_cast<long long>(j0 + jj) * HD + c;
        sk[jj][c] = to_float(kb[off]);
        sv[jj][c] = to_float(vb[off]);
      }
      for (int idx = threadIdx.x; idx < kMbTile * kMbStream; idx += kMbTile) {
        const int ii = idx / kMbStream, jj = idx % kMbStream;
        sm[ii][jj] = (q0 + ii < p.Rq && jj < nk)
                         ? mb[static_cast<long long>(q0 + ii) * p.Rk + j0 + jj]
                         : 0.f;
      }
      __syncthreads();
      if (active) {
        for (int jj = 0; jj < nk; ++jj) {
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int c = 0; c < HD; ++c) {
            s += qr[c] * sk[jj][c];
            dp += gi[c] * sv[jj][c];
          }
          s += sm[threadIdx.x][jj];
          if (pass == 0) {
            if (s > m) {
              const float corr = expf(m - s);
              l *= corr;
              D *= corr;
              m = s;
            }
            const float e = expf(s - m);
            l += e;
            D += e * dp;  // D_i = sum_j P_ij (g_i.v_j), unnormalised
          } else {
            const float ds = expf(s - lse) * (dp - D);
#pragma unroll
            for (int c = 0; c < HD; ++c) acc[c] += ds * sk[jj][c];
          }
        }
      }
      __syncthreads();
    }
    if (pass == 0 && active) {
      lse = m + logf(l);
      D /= l;
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < HD; ++c) dq[qoff + c] = from_float<T>(acc[c] * p.scale);
    lse_out[gh * p.Rq + i] = lse;
    d_out[gh * p.Rq + i] = D;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMbTile)
masked_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ mask, const T* __restrict__ g,
                      const float* __restrict__ lse_in, const float* __restrict__ d_in,
                      T* __restrict__ dk, T* __restrict__ dv, MaskedBwdParams p) {
  __shared__ float sq[kMbStream][HD + 1];
  __shared__ float sg[kMbStream][HD + 1];
  __shared__ float sm[kMbStream][kMbTile + 1];
  __shared__ float slse[kMbStream];
  __shared__ float sD[kMbStream];
  const int grp = blockIdx.y, head = blockIdx.z;
  const int k0 = blockIdx.x * kMbTile;
  const int j = k0 + threadIdx.x;
  const bool active = j < p.Rk;
  const long long gh = static_cast<long long>(head) * p.G + grp;
  const T* qb = q + gh * p.Rq * HD;
  const T* gb = g + gh * p.Rq * HD;
  const float* mb = mask + static_cast<long long>(grp % p.Gm) * p.Rq * p.Rk;
  const long long koff = (gh * p.Rk + j) * HD;

  float kj[HD], vj[HD], dkj[HD], dvj[HD];
  if (active) {
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      kj[c] = to_float(k[koff + c]);
      vj[c] = to_float(v[koff + c]);
    }
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) dkj[c] = dvj[c] = 0.f;

  for (int i0 = 0; i0 < p.Rq; i0 += kMbStream) {
    const int nq = min(kMbStream, p.Rq - i0);
    for (int idx = threadIdx.x; idx < nq * HD; idx += kMbTile) {
      const int ii = idx / HD, c = idx % HD;
      const long long off = static_cast<long long>(i0 + ii) * HD + c;
      sq[ii][c] = to_float(qb[off]) * p.scale;
      sg[ii][c] = to_float(gb[off]);
    }
    for (int idx = threadIdx.x; idx < kMbStream * kMbTile; idx += kMbTile) {
      const int ii = idx / kMbTile, jj = idx % kMbTile;
      sm[ii][jj] = (ii < nq && k0 + jj < p.Rk)
                       ? mb[static_cast<long long>(i0 + ii) * p.Rk + k0 + jj]
                       : 0.f;
    }
    if (threadIdx.x < nq) {
      slse[threadIdx.x] = lse_in[gh * p.Rq + i0 + threadIdx.x];
      sD[threadIdx.x] = d_in[gh * p.Rq + i0 + threadIdx.x];
    }
    __syncthreads();
    if (active) {
      for (int ii = 0; ii < nq; ++ii) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          s += sq[ii][c] * kj[c];
          dp += sg[ii][c] * vj[c];
        }
        s += sm[ii][threadIdx.x];
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
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      dk[koff + c] = from_float<T>(dkj[c]);
      dv[koff + c] = from_float<T>(dvj[c]);
    }
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const float* mask, const void* g,
               void* dq, void* dk, void* dv, float* lse, float* dsum, MaskedBwdParams p,
               cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(g);
  dim3 grid_q((p.Rq + kMbTile - 1) / kMbTile, p.G, p.heads);
  masked_bwd_dq_kernel<T, HD><<<grid_q, kMbTile, 0, stream>>>(
      q_, k_, v_, mask, g_, static_cast<T*>(dq), lse, dsum, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_k((p.Rk + kMbTile - 1) / kMbTile, p.G, p.heads);
  masked_bwd_dkv_kernel<T, HD><<<grid_k, kMbTile, 0, stream>>>(
      q_, k_, v_, mask, g_, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(int hd, const void* q, const void* k, const void* v, const float* mask,
                 const void* g, void* dq, void* dk, void* dv, float* lse, float* dsum,
                 MaskedBwdParams p, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(q, k, v, mask, g, dq, dk, dv, lse, dsum, p, s);
    case 32: return launch_bwd<T, 32>(q, k, v, mask, g, dq, dk, dv, lse, dsum, p, s);
    case 64: return launch_bwd<T, 64>(q, k, v, mask, g, dq, dk, dv, lse, dsum, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nmrf

extern "C" int nmrf_masked_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* mask, const void* g, void* dq, void* dk,
                                         void* dv, void* lse, void* dsum, int dtype, int G,
                                         int Gm, int heads, int Rq, int Rk, int hd,
                                         float scale, void* stream) {
  using namespace nmrf;
  if (G <= 0 || Gm <= 0 || heads <= 0 || Rq <= 0 || Rk <= 0 || G > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  MaskedBwdParams p;
  p.G = G; p.Gm = Gm; p.heads = heads; p.Rq = Rq; p.Rk = Rk; p.scale = scale;
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(dsum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_bwd<float>(hd, q, k, v, m, g, dq, dk, dv, l, d, p, s);
  if (dtype == kBF16)
    return dispatch_bwd<__nv_bfloat16>(hd, q, k, v, m, g, dq, dk, dv, l, d, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
