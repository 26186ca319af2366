// CSWin stripe attention with the anti-same-pixel mask (K2).
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
// A masked key gets P = 0, which equals adding -1e9: every row keeps its own
// token.
//
// Bound on the H100 (bf16, KITTI serving path): a launch must read q, k, v
// and write the output once (about 15 MB: 0.0046 ms) and do q.k and p.v of
// every stripe (4.7 GFLOP at T = 624, 1.4 GFLOP at T = 188: 0.0047 and
// 0.0014 ms at the bf16 tensor-core rate); the two are close.
//
// bf16 (every launch of the serving and training paths): a flash-attention
// forward on the tensor cores, mma.sync.m16n8k16 with bf16 operands and f32
// accumulation, fed by ldmatrix.  Blocks of 4 warps own 64 query rows, 16
// per warp; key and value rows stream through shared memory 64 at a time,
// double-buffered with 16-byte cp.async, rows padded to HD + 8 elements
// (stripe_tiles.cuh, shared with K2b).  Per 16-key chunk: S = Q K^T, the
// anti-same-pixel mask as two compares against the row's pixel range (and
// keys past T), the running max and sum in f32 with quad shuffles, and P,
// rounded to bf16, reused as the A fragment of O += P V with V by
// ldmatrix.trans.  One normalisation at the end; each output row is written
// once, so the T x T logits (1.5 MB in f32 at T = 624) never exist.  The
// ragged last tiles (188 = 2 x 64 + 60, 624 = 9 x 64 + 48) are zero-filled
// by the loader and masked.  wgmma is not needed: a stripe is at most 624
// keys and hd 32 is two k-steps, so mma.sync tiles suffice.
//
// f32 (the phase 3 checks at 1e-4, which TF32 would not meet): the CUDA-core
// version, one block of 64 threads per (64-query tile, stripe, head), one
// query row per thread with q and the output accumulator in registers, key
// and value rows streamed through shared memory, an online softmax in f32.

#include "common.cuh"
#include "stripe_tiles.cuh"

namespace nmrf {

constexpr int kTile = 64;

template <typename T, int HD>
__global__ void __launch_bounds__(kTile)
stripe_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, StripeParams p) {
  __shared__ float sk[kTile][HD + 1];
  __shared__ float sv[kTile][HD + 1];
  const int stripe = blockIdx.y, head = blockIdx.z;
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool active = i < p.T;
  float qr[HD], acc[HD];
  if (active) {
    const T* qi = q + stripe_offset(p, stripe, head, HD, i);
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
  if (active) {
    T* o = out + stripe_offset(p, stripe, head, HD, i);
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] = from_float<T>(acc[c] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// five [64, HD + 8] bf16 tiles: the block's q rows, and k and v rows,
// double-buffered
template <int HD>
constexpr size_t stripe_fwd_smem_bytes() {
  return static_cast<size_t>(5) * kMmaRows * mma_ld<HD>() * sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
stripe_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            StripeParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = mma_ld<HD>(), KS = HD / 16, NTD = HD / 8, TILE = kMmaRows * LD;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + TILE;      // [2][TILE]
  bf16* sV = sK + 2 * TILE;  // [2][TILE]
  const int stripe = blockIdx.y, head = blockIdx.z, i0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  const long long base = stripe_base(p, stripe, head, HD);
  const int nkt = (p.T + kMmaRows - 1) / kMmaRows;
  // logits in log2 units, so that exp2 takes the place of exp
  const float sl2 = p.scale * 1.4426950408889634f;

  stage_tile<HD>(sQ, q, base, i0, p);
  stage_rows<HD>(sK, k, sV, v, base, 0, p);
  cp_async_commit();

  int qi[2], lo[2];  // the thread's two query rows and their pixel's first token
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = i0 + warp * 16 + gq + 8 * r;
    lo[r] = qi[r] / p.N * p.N;
  }
  uint32_t qa[KS][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oa[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n) oa[n][0] = oa[n][1] = oa[n][2] = oa[n][3] = 0.f;

  for (int it = 0; it < nkt; ++it) {
    const int buf = it & 1;
    if (it + 1 < nkt)
      stage_rows<HD>(sK + (buf ^ 1) * TILE, k, sV + (buf ^ 1) * TILE, v, base,
                     (it + 1) * kMmaRows, p);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) load_a(qa[ks], sQ, LD, warp * 16, ks * 16, lane);
    }
    const bf16* tk = sK + buf * TILE;
    const bf16* tv = sV + buf * TILE;
    const int j0 = it * kMmaRows;
    for (int kc = 0; kc < kMmaRows / 16 && j0 + kc * 16 < p.T; ++kc) {
      float s[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        load_b_rows(b, tk, LD, kc * 16, ks * 16, lane);
        mma_bf16(s[0], qa[ks], b[0], b[1]);
        mma_bf16(s[1], qa[ks], b[2], b[3]);
      }
      // logits; -inf past T and between different candidates of a pixel
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = j0 + kc * 16 + nt * 8 + 2 * t4 + (e & 1);
          const bool ok = j < p.T && !(j >= lo[r] && j < lo[r] + p.N && j != qi[r]);
          s[nt][e] = ok ? s[nt][e] * sl2 : -INFINITY;
        }
      // online softmax: running max and sum; rescale the output rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mx = quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                        fmaxf(s[1][2 * r], s[1][2 * r + 1])));
        const float mn = fmaxf(m[r], mx);
        const float mu = mn == -INFINITY ? 0.f : mn;
        const float corr = exp2f(m[r] - mu);
        l[r] *= corr;
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
          oa[n][2 * r] *= corr;
          oa[n][2 * r + 1] *= corr;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float e = exp2f(s[nt][2 * r + c] - mu);
            s[nt][2 * r + c] = e;
            l[r] += e;
          }
        m[r] = mn;
      }
      // O += P V, P as the A fragment
      uint32_t a[4];
      c_to_a(a, s[0], s[1]);
#pragma unroll
      for (int nd = 0; nd < NTD / 2; ++nd) {
        uint32_t b[4];
        load_b_cols(b, tv, LD, kc * 16, nd * 16, lane);
        mma_bf16(oa[2 * nd], a, b[0], b[1]);
        mma_bf16(oa[2 * nd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / quad_sum(l[r]);
    if (qi[r] >= p.T) continue;
    bf16* dst = out + base + stripe_token(p, qi[r]) + 2 * t4;
#pragma unroll
    for (int n = 0; n < NTD; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(oa[n][2 * r] * inv, oa[n][2 * r + 1] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, StripeParams p,
           cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    constexpr int smem = static_cast<int>(stripe_fwd_smem_bytes<HD>());
    const cudaError_t err = ensure_smem(stripe_attention_mma_kernel<HD>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((p.T + kMmaRows - 1) / kMmaRows, p.B * p.ni * p.nj, p.heads);
    stripe_attention_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), p);
  } else {
    dim3 grid((p.T + kTile - 1) / kTile, p.B * p.ni * p.nj, p.heads);
    stripe_attention_kernel<T, HD><<<grid, kTile, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), p);
  }
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
  const StripeParams p = stripe_params(B, Hp, Wp, N, C, heads, H_sp, W_sp, scale);
  const int hd = C / heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_hd<float>(hd, q, k, v, out, p, s);
  if (dtype == kBF16) return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
