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
// (T = 624 at KITTI size, 1.5 MB in f32 per head) never exist.  Kernel 1
// (query side) gives each query row's log-sum-exp and D_i in f32, kept in a
// [stripes, h, T] f32 buffer, and dq; kernel 2 (key side) walks the query
// rows with them and gives dk and dv.  Every output row is written once by
// one owner: no atomics, and two launches on the same inputs give the same
// bits.  Inputs and outputs stay in the padded image layout [B, Hp, Wp, N, C].
//
// Bound on the H100 (bf16, training shape 48x96, batch 8): the launch must
// read q, k, v, g and write dq, dk, dv once (132 MB: 0.039 ms per launch)
// and do five T x T products (18 GFLOP at T = 192: 0.018 ms at the bf16
// tensor-core rate); the bytes bound it.
//
// bf16 (the training step's launch): the T x T products run on the tensor
// cores, mma.sync.m16n8k16 with bf16 operands and f32 accumulation, fed by
// ldmatrix (.trans where a product takes the transposed tile).  Blocks of 4
// warps own 64 rows, 16 per warp; the other side's rows stream through
// shared memory 64 at a time, double-buffered with 16-byte cp.async, rows
// padded to HD + 8 elements so ldmatrix has no bank conflict (the loader
// of stripe_tiles.cuh, shared with K2).  A token's
// head slice is 2 HD contiguous bytes; its offset is computed once per row
// of a tile (one division), and the anti-same-pixel mask is two compares
// against the row's pixel range.
//   Kernel 1: a first pass takes S = Q K^T and dP = G V^T per 16-key chunk
//   and keeps the online softmax's max, sum and sum of P dP, so lse and
//   D_i = sum_j P_ij dP_ij come out in f32 without the output O; a second
//   pass recomputes S and dP, forms dS = P (dP - D) in the accumulators and
//   reuses them as the A fragment of dq += dS K.
//   Kernel 2: with the block's k and v rows as A fragments, S^T = K Q^T and
//   dP^T = V G^T per 16-query chunk, P^T = exp(S^T - lse) and dS^T; then
//   dv += P^T G and dk += dS^T Q.
// Softmax, lse, D and every sum stay in f32; P and dS are rounded to bf16
// only as mma operands, as FlashAttention-2 does.  wgmma is not needed: the
// work is bound by bytes and the tiles are small (hd 32 is two k-steps), so
// mma.sync tiles are enough.  This version runs at 9-16x the byte bound
// (PERF.md); what holds it there is not measured (ncu does not run on the
// card's machine): the candidates are the barriers of each streamed tile
// with 4 warps per block, and the exp and mask work of the elementwise part.
//
// f32 (phase 3 and 4 checks at 1e-4): kept on CUDA cores, which TF32 would
// not meet.  One block of 64 threads per (64-row tile, stripe, head), one
// row per thread, every dot product in f32 from shared memory.

#include "common.cuh"
#include "stripe_tiles.cuh"

namespace nmrf {

constexpr int kBwdTile = 64;

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdTile)
stripe_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ lse_out,
                     float* __restrict__ d_out, StripeParams p) {
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
                      StripeParams p) {
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

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// six [64, HD + 8] bf16 tiles (own rows: two; streamed rows: two tensors,
// double-buffered) and the key side's lse and D of two query tiles
template <int HD>
constexpr size_t stripe_mma_smem_bytes() {
  return static_cast<size_t>(6) * kMmaRows * mma_ld<HD>() * sizeof(bf16) +
         static_cast<size_t>(4) * kMmaRows * sizeof(float);
}

// Kernel 1: lse, D and dq of 64 query rows; key rows stream through.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
stripe_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ gout,
                         bf16* __restrict__ dq, float* __restrict__ lse_out,
                         float* __restrict__ d_out, StripeParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = mma_ld<HD>(), KS = HD / 16, NTD = HD / 8, TILE = kMmaRows * LD;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + TILE;
  bf16* sK = sG + TILE;      // [2][TILE]
  bf16* sV = sK + 2 * TILE;  // [2][TILE]
  const int stripe = blockIdx.y, head = blockIdx.z, i0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  const long long base = stripe_base(p, stripe, head, HD);
  const int nkt = (p.T + kMmaRows - 1) / kMmaRows;

  stage_rows<HD>(sQ, q, sG, gout, base, i0, p);
  stage_rows<HD>(sK, k, sV, v, base, 0, p);
  cp_async_commit();

  int qi[2], lo[2];  // the thread's two query rows and their pixel's first token
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = i0 + warp * 16 + gq + 8 * r;
    lo[r] = qi[r] / p.N * p.N;
  }
  uint32_t qa[KS][4], ga[KS][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};
  float dqa[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  // tiles 0..nkt-1: pass 1 (lse, D); tiles nkt..2nkt-1: pass 2 (dq)
  for (int it = 0; it < 2 * nkt; ++it) {
    const int buf = it & 1;
    if (it + 1 < 2 * nkt)
      stage_rows<HD>(sK + (buf ^ 1) * TILE, k, sV + (buf ^ 1) * TILE, v, base,
                     ((it + 1) % nkt) * kMmaRows, p);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        load_a(qa[ks], sQ, LD, warp * 16, ks * 16, lane);
        load_a(ga[ks], sG, LD, warp * 16, ks * 16, lane);
      }
    }
    if (it == nkt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float ls = quad_sum(l[r]);
        lse[r] = m[r] + logf(ls);
        D[r] = quad_sum(pd[r]) / ls;
      }
    }
    const bf16* tk = sK + buf * TILE;
    const bf16* tv = sV + buf * TILE;
    const int j0 = (it % nkt) * kMmaRows;
    for (int kc = 0; kc < kMmaRows / 16 && j0 + kc * 16 < p.T; ++kc) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        load_b_rows(b, tk, LD, kc * 16, ks * 16, lane);
        mma_bf16(s[0], qa[ks], b[0], b[1]);
        mma_bf16(s[1], qa[ks], b[2], b[3]);
        load_b_rows(b, tv, LD, kc * 16, ks * 16, lane);
        mma_bf16(dp[0], ga[ks], b[0], b[1]);
        mma_bf16(dp[1], ga[ks], b[2], b[3]);
      }
      // logits; -inf past T and between different candidates of a pixel
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = j0 + kc * 16 + nt * 8 + 2 * t4 + (e & 1);
          const bool ok = j < p.T && !(j >= lo[r] && j < lo[r] + p.N && j != qi[r]);
          s[nt][e] = ok ? s[nt][e] * p.scale : -INFINITY;
        }
      if (it < nkt) {  // online softmax: running max, sum and sum of P dP
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mx = quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                          fmaxf(s[1][2 * r], s[1][2 * r + 1])));
          const float mn = fmaxf(m[r], mx);
          const float mu = mn == -INFINITY ? 0.f : mn;
          const float corr = __expf(m[r] - mu);
          l[r] *= corr;
          pd[r] *= corr;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float e = __expf(s[nt][2 * r + c] - mu);
              l[r] += e;
              pd[r] += e * dp[nt][2 * r + c];
            }
          m[r] = mn;
        }
      } else {  // dS = P (dP - D), then dq += dS K
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[nt][e] = __expf(s[nt][e] - lse[e >> 1]) * (dp[nt][e] - D[e >> 1]);
        uint32_t a[4];
        c_to_a(a, dp[0], dp[1]);
#pragma unroll
        for (int nd = 0; nd < NTD / 2; ++nd) {
          uint32_t b[4];
          load_b_cols(b, tk, LD, kc * 16, nd * 16, lane);
          mma_bf16(dqa[2 * nd], a, b[0], b[1]);
          mma_bf16(dqa[2 * nd + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= p.T) continue;
    const long long off = base + stripe_token(p, qi[r]);
#pragma unroll
    for (int n = 0; n < NTD; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(dqa[n][2 * r] * p.scale, dqa[n][2 * r + 1] * p.scale);
    if (t4 == 0) {
      const long long row = (static_cast<long long>(stripe) * p.heads + head) * p.T + qi[r];
      lse_out[row] = lse[r];
      d_out[row] = D[r];
    }
  }
}

// Kernel 2: dk and dv of 64 key rows; query rows, g rows and their lse and D
// stream through.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
stripe_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ gout,
                          const float* __restrict__ lse_in, const float* __restrict__ d_in,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, StripeParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = mma_ld<HD>(), KS = HD / 16, NTD = HD / 8, TILE = kMmaRows * LD;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;      // [2][TILE]
  bf16* sG = sQ + 2 * TILE;  // [2][TILE]
  float* sL = reinterpret_cast<float*>(sG + 2 * TILE);  // [2][64] lse
  float* sD = sL + 2 * kMmaRows;                         // [2][64] D
  const int stripe = blockIdx.y, head = blockIdx.z, j0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  const long long base = stripe_base(p, stripe, head, HD);
  const long long srow = (static_cast<long long>(stripe) * p.heads + head) * p.T;
  const int nqt = (p.T + kMmaRows - 1) / kMmaRows;
  // lse and D of query tile i0 (zero past T, where q and g rows are zero too)
  auto stage_stats = [&](int buf, int i0) {
    if (threadIdx.x < kMmaRows) {
      const int i = i0 + threadIdx.x;
      sL[buf * kMmaRows + threadIdx.x] = i < p.T ? lse_in[srow + i] : 0.f;
      sD[buf * kMmaRows + threadIdx.x] = i < p.T ? d_in[srow + i] : 0.f;
    }
  };

  stage_rows<HD>(sK, k, sV, v, base, j0, p);
  stage_rows<HD>(sQ, q, sG, gout, base, 0, p);
  stage_stats(0, 0);
  cp_async_commit();

  int kj[2], lo[2];  // the thread's two key rows and their pixel's first token
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kj[r] = j0 + warp * 16 + gq + 8 * r;
    lo[r] = kj[r] / p.N * p.N;
  }
  uint32_t ka[KS][4], va[KS][4];
  float dka[NTD][4], dva[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < nqt; ++it) {
    const int buf = it & 1;
    if (it + 1 < nqt) {
      stage_rows<HD>(sQ + (buf ^ 1) * TILE, q, sG + (buf ^ 1) * TILE, gout, base,
                     (it + 1) * kMmaRows, p);
      stage_stats(buf ^ 1, (it + 1) * kMmaRows);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        load_a(ka[ks], sK, LD, warp * 16, ks * 16, lane);
        load_a(va[ks], sV, LD, warp * 16, ks * 16, lane);
      }
    }
    const bf16* tq = sQ + buf * TILE;
    const bf16* tg = sG + buf * TILE;
    const float* tl = sL + buf * kMmaRows;
    const float* td = sD + buf * kMmaRows;
    const int i0 = it * kMmaRows;
    for (int qc = 0; qc < kMmaRows / 16 && i0 + qc * 16 < p.T; ++qc) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        load_b_rows(b, tq, LD, qc * 16, ks * 16, lane);
        mma_bf16(s[0], ka[ks], b[0], b[1]);
        mma_bf16(s[1], ka[ks], b[2], b[3]);
        load_b_rows(b, tg, LD, qc * 16, ks * 16, lane);
        mma_bf16(dp[0], va[ks], b[0], b[1]);
        mma_bf16(dp[1], va[ks], b[2], b[3]);
      }
      // P^T and dS^T (rows: keys, columns: queries)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, il = qc * 16 + nt * 8 + 2 * t4 + (e & 1), i = i0 + il;
          const bool ok = i < p.T && !(i >= lo[r] && i < lo[r] + p.N && i != kj[r]);
          const float pr = ok ? __expf(s[nt][e] * p.scale - tl[il]) : 0.f;
          s[nt][e] = pr;
          dp[nt][e] = pr * (dp[nt][e] - td[il]);
        }
      uint32_t pa[4], da[4];
      c_to_a(pa, s[0], s[1]);
      c_to_a(da, dp[0], dp[1]);
#pragma unroll
      for (int nd = 0; nd < NTD / 2; ++nd) {
        uint32_t b[4];
        load_b_cols(b, tg, LD, qc * 16, nd * 16, lane);
        mma_bf16(dva[2 * nd], pa, b[0], b[1]);
        mma_bf16(dva[2 * nd + 1], pa, b[2], b[3]);
        load_b_cols(b, tq, LD, qc * 16, nd * 16, lane);
        mma_bf16(dka[2 * nd], da, b[0], b[1]);
        mma_bf16(dka[2 * nd + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= p.T) continue;
    const long long off = base + stripe_token(p, kj[r]);
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      const int c = n * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
          __floats2bfloat162_rn(dka[n][2 * r] * p.scale, dka[n][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int HD>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, float* lse, float* dsum, StripeParams p,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(stripe_mma_smem_bytes<HD>());
  cudaError_t err = ensure_smem(stripe_bwd_dq_mma_kernel<HD>, smem);
  if (err == cudaSuccess) err = ensure_smem(stripe_bwd_dkv_mma_kernel<HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.T + kMmaRows - 1) / kMmaRows, p.B * p.ni * p.nj, p.heads);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* g_ = static_cast<const bf16*>(g);
  stripe_bwd_dq_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      q_, k_, v_, g_, static_cast<bf16*>(dq), lse, dsum, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stripe_bwd_dkv_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      q_, k_, v_, g_, lse, dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, float* lse, float* dsum, StripeParams p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_bwd_mma<HD>(q, k, v, g, dq, dk, dv, lse, dsum, p, stream);
  } else {
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
}

template <typename T>
int dispatch_bwd(int hd, const void* q, const void* k, const void* v, const void* g, void* dq,
                 void* dk, void* dv, float* lse, float* dsum, StripeParams p,
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
  const StripeParams p = stripe_params(B, Hp, Wp, N, C, heads, H_sp, W_sp, scale);
  const int hd = C / heads;
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(dsum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_bwd<float>(hd, q, k, v, g, dq, dk, dv, l, d, p, s);
  if (dtype == kBF16) return dispatch_bwd<__nv_bfloat16>(hd, q, k, v, g, dq, dk, dv, l, d, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
