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
// Bound on the H100 (bf16, Rq 96, Rk 192, G 768, 2 heads of 32, Gm 1;
// chip_smoke.py:masked_bound): q, k, v, g and the mask read and dq, dk, dv
// written once (104 MB: 31 us per launch) against five Rq x Rk products per
// (group, head) (9.1 GFLOP: 9 us at the bf16 tensor-core rate); the bytes
// bound it.
//
// Design: the flash-attention-2 split, so the Rq x Rk logits never exist.
// Kernel 1 (query side) gives each query row's softmax statistics in f32
// and dq; kernel 2 (key side) walks the query rows with them and gives dk
// and dv.  The statistics are the row max m_i and log-sum ls_i (the
// wrapper's lse buffer, [2, h, G, Rq]) and D_i ([h, G, Rq]); P_ij is
// exp((logit - m_i) - ls_i).  The two are kept apart because m_i + ls_i
// loses ls_i where m_i is near -1e9: in a row masked everywhere that gave
// P = 1 for every key instead of the plain version's uniform 1/Rk (the
// first CUDA-core version did; the JAX kernel recomputes the softmax
// whole).  Every output row is written once by one owner: no atomics, and
// two launches on the same inputs give the same bits (a block's range of
// units does not change the arithmetic of a unit).
//
// bf16 (every launch of the sharded training step): K2b's two kernels
// (stripe_attention_bwd.cu) on dense rows with the explicit mask.
// mma.sync m16n8k16 with bf16 operands and f32 accumulation, fed by
// ldmatrix (.trans where a product takes the transposed tile), rows staged
// by 16-byte cp.async into rows padded to HD + 8 (masked_tiles.cuh).
//   Kernel 1: a block of Rq/16 warps (at most 8) owns the query rows of a
//   (group, head) pair (6 warps at Rq 96); 64-key tiles stream through,
//   double-buffered, twice.  Pass one takes S = Q K^T + mask and dP = G V^T
//   per 16-key chunk and keeps the online softmax's max, sum and sum of
//   P dP, so m, ls and D_i come out in f32 without O; pass two recomputes S
//   and dP, forms dS = P (dP - D) in the accumulators and reuses them as
//   the A fragment of dq += dS K.
//   Kernel 2: a block of 4 warps owns 64 key rows of a pair (Rk 192 is
//   three tiles); the query rows, g rows and their statistics stream through
//   in 64-row tiles (Rq 96 = 64 + 32, zero-filled and masked).  With the
//   block's k and v rows as A fragments: S^T = K Q^T + mask^T and
//   dP^T = V G^T per 16-query chunk, P^T = exp(S^T - m - ls) and dS^T, then
//   dv += P^T G and dk += dS^T Q.  The mask is read transposed (C row: key
//   j, C column: query i, the value mask[i][j]) from a [Rq, 64-key] strip
//   staged in shared memory with a row stride that keeps those column
//   reads free of bank conflicts.
// Both kernels walk contiguous ranges of units (kernel 1: pairs; kernel 2:
// a key tile of a pair), and stage their mask rows (77 KB, and the 26 KB
// strip, at the path's shape) once per block and mask class, not once per
// unit; where they do not fit in shared memory the mask is read from device
// memory at the fragments' positions.  At the path's shape kernel 1 takes
// 113 KB of shared memory (two blocks, 12 warps an SM) and kernel 2 68 KB
// (three blocks, 12 warps).  Softmax, m, ls, D and every sum stay in f32; P
// and dS are rounded to bf16 only as mma operands, as FlashAttention-2
// does.  Expected above the bound: each unit's chain of tiles with a barrier
// per tile (kernel 1 streams k and v twice), and the exp and mask work of
// the elementwise part.
//
// f32 (phase 2 and phase 7's f32 checks at 1e-4, which TF32 would not
// meet): the CUDA-core version, one block of 64 threads per (64-row tile,
// group, head), one row per thread, every dot product in f32 from shared
// memory.

#include "common.cuh"
#include "masked_tiles.cuh"

namespace nmrf {

constexpr int kMbTile = 64;   // rows owned by a block (queries or keys)
constexpr int kMbStream = 32; // rows streamed through shared memory at a time

template <typename T, int HD>
__global__ void __launch_bounds__(kMbTile)
masked_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, const T* __restrict__ g,
                     T* __restrict__ dq, float* __restrict__ lse_out, float* __restrict__ d_out,
                     MaskedParams p) {
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
  float m = -INFINITY, l = 0.f, ll = 0.f, D = 0.f;

  // pass 0: online softmax (B6's loop) -> row max, log-sum, D_i;
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
            const float ds = expf((s - m) - ll) * (dp - D);
#pragma unroll
            for (int c = 0; c < HD; ++c) acc[c] += ds * sk[jj][c];
          }
        }
      }
      __syncthreads();
    }
    if (pass == 0 && active) {
      ll = logf(l);
      D /= l;
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < HD; ++c) dq[qoff + c] = from_float<T>(acc[c] * p.scale);
    lse_out[gh * p.Rq + i] = m;
    lse_out[static_cast<long long>(p.heads) * p.G * p.Rq + gh * p.Rq + i] = ll;
    d_out[gh * p.Rq + i] = D;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMbTile)
masked_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ mask, const T* __restrict__ g,
                      const float* __restrict__ lse_in, const float* __restrict__ d_in,
                      T* __restrict__ dk, T* __restrict__ dv, MaskedParams p) {
  __shared__ float sq[kMbStream][HD + 1];
  __shared__ float sg[kMbStream][HD + 1];
  __shared__ float sm[kMbStream][kMbTile + 1];
  __shared__ float smax[kMbStream];
  __shared__ float sll[kMbStream];
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
      const long long row = gh * p.Rq + i0 + threadIdx.x;
      smax[threadIdx.x] = lse_in[row];
      sll[threadIdx.x] = lse_in[static_cast<long long>(p.heads) * p.G * p.Rq + row];
      sD[threadIdx.x] = d_in[row];
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
        const float pr = expf((s - smax[ii]) - sll[ii]);
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

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// how a launch cuts its work.  Kernel 1: units (row tile, group, head), u =
// (qt G + g) heads + head, each q_rows query rows of one pair; kernel 2:
// units (key tile, group, head), u = (kt G + g) heads + head, each 64 key
// rows of one pair
struct MaskedBwdTiling {
  int q_rows, units, mask_ld;
  int resident;  // the block's mask rows (kernel 1) or strip (kernel 2) are in shared memory
};

// kernel 1: q and g tiles (one each: a unit reads them at its first step
// only), k and v tiles (two each), the staged mask rows when resident
template <int HD>
inline size_t masked_dq_smem_bytes(const MaskedBwdTiling& t, bool resident) {
  return (static_cast<size_t>(2) * t.q_rows + 4 * kMmaRows) * mma_ld<HD>() * sizeof(bf16) +
         (resident ? static_cast<size_t>(t.q_rows) * t.mask_ld * sizeof(float) : 0);
}

// kernel 2: k and v tiles (two each, by unit), q and g tiles (two each), row
// max, log-sum and D of two query tiles, the [Rq, 64] strip when resident (rows: Rq
// rounded up to 16)
template <int HD>
inline size_t masked_dkv_smem_bytes(int Rq, bool resident) {
  return static_cast<size_t>(8) * kMmaRows * mma_ld<HD>() * sizeof(bf16) +
         static_cast<size_t>(6) * kMmaRows * sizeof(float) +
         (resident ? static_cast<size_t>((Rq + 15) / 16 * 16) * kMaskStripLd * sizeof(float) : 0);
}

// Kernel 1: row max, log-sum, D and dq of a pair's query rows; key rows
// stream through.
template <int HD>
__global__ void __launch_bounds__(256)
masked_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ mask,
                         const bf16* __restrict__ gout, bf16* __restrict__ dq,
                         float* __restrict__ lse_out, float* __restrict__ d_out, MaskedParams p,
                         MaskedBwdTiling t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = mma_ld<HD>(), KS = HD / 16, NTD = HD / 8, KTILE = kMmaRows * LD;
  const int QTILE = t.q_rows * LD;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + QTILE;
  bf16* sK = sG + QTILE;      // [2][KTILE]
  bf16* sV = sK + 2 * KTILE;  // [2][KTILE]
  float* sM = reinterpret_cast<float*>(sV + 2 * KTILE);  // [q_rows, mask_ld] if resident
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  const int nkt = (p.Rk + kMmaRows - 1) / kMmaRows, steps = 2 * nkt;
  int u0, u1;
  unit_range(t.units, u0, u1);
  const int nitems = (u1 - u0) * steps;  // (unit, step): steps 0..nkt-1 pass one, then pass two

  // k and v rows of the item's key tile, and the unit's q and g rows with
  // its first step.  One q and g buffer suffices: the next unit's rows are
  // staged during this unit's last step, and this unit read its own at its
  // first step, at least one barrier earlier.
  auto stage = [&](int item) {
    const int u = u0 + item / steps, kt = (item % steps) % nkt;
    const int qt = u / (p.G * p.heads), g = (u / p.heads) % p.G, head = u % p.heads;
    const long long gh = static_cast<long long>(head) * p.G + g;
    if (item % steps == 0) {
      stage_dense<HD>(sQ, q + gh * p.Rq * HD, qt * t.q_rows, t.q_rows, p.Rq);
      stage_dense<HD>(sG, gout + gh * p.Rq * HD, qt * t.q_rows, t.q_rows, p.Rq);
    }
    stage_dense<HD>(sK + (item & 1) * KTILE, k + gh * p.Rk * HD, kt * kMmaRows, kMmaRows, p.Rk);
    stage_dense<HD>(sV + (item & 1) * KTILE, v + gh * p.Rk * HD, kt * kMmaRows, kMmaRows, p.Rk);
  };

  if (nitems > 0) stage(0);
  cp_async_commit();

  int staged = -1;  // mask class (qt, g % Gm) of the rows in sM
  const float* mrow[2] = {nullptr, nullptr};  // device-memory mask rows when not resident
  int qi[2] = {0, 0};
  uint32_t qa[KS][4], ga[KS][4];
  float m[2], l[2], pd[2], ll[2], D[2];
  float dqa[NTD][4];
  long long gh = 0;

  for (int it = 0; it < nitems; ++it) {
    const int step = it % steps, kt = step % nkt;
    const int u = u0 + it / steps;
    const int qt = u / (p.G * p.heads), g = (u / p.heads) % p.G, head = u % p.heads;
    if (step == 0) {
      const int cls = qt * p.Gm + g % p.Gm;
      const float* mb = mask + static_cast<long long>(g % p.Gm) * p.Rq * p.Rk;
      // the last reader of sM passed the barrier that ended the previous item
      if (t.resident && cls != staged) {
        stage_mask(sM, t.mask_ld, mb, p.Rq, p.Rk, qt * t.q_rows, t.q_rows, 0,
                   (p.Rk + 15) / 16 * 16);
        staged = cls;
      }
      gh = static_cast<long long>(head) * p.G + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qi[r] = qt * t.q_rows + warp * 16 + gq + 8 * r;
        mrow[r] = mb + static_cast<long long>(qi[r] < p.Rq ? qi[r] : 0) * p.Rk;
        m[r] = -INFINITY;
        l[r] = pd[r] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < NTD; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
    }
    cp_async_commit();  // the mask rows, if staged: complete at the wait below
    if (it + 1 < nitems) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (step == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        load_a(qa[ks], sQ, LD, warp * 16, ks * 16, lane);
        load_a(ga[ks], sG, LD, warp * 16, ks * 16, lane);
      }
    }
    if (step == nkt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float ls = quad_sum(l[r]);
        ll[r] = logf(ls);
        D[r] = quad_sum(pd[r]) / ls;
      }
    }
    const bf16* tk = sK + (it & 1) * KTILE;
    const bf16* tv = sV + (it & 1) * KTILE;
    const int j0 = kt * kMmaRows;
    for (int kc = 0; kc < kMmaRows / 16 && j0 + kc * 16 < p.Rk; ++kc) {
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
      // logits + mask; -inf past Rk
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = j0 + kc * 16 + nt * 8 + 2 * t4;
          float2 mv;
          if (t.resident) {
            mv = *reinterpret_cast<const float2*>(sM + (warp * 16 + gq + 8 * r) * t.mask_ld + j);
          } else {
            const bool row = qi[r] < p.Rq;
            mv.x = row && j < p.Rk ? __ldg(mrow[r] + j) : 0.f;
            mv.y = row && j + 1 < p.Rk ? __ldg(mrow[r] + j + 1) : 0.f;
          }
          s[nt][2 * r] = j < p.Rk ? fmaf(s[nt][2 * r], p.scale, mv.x) : -INFINITY;
          s[nt][2 * r + 1] = j + 1 < p.Rk ? fmaf(s[nt][2 * r + 1], p.scale, mv.y) : -INFINITY;
        }
      if (step < nkt) {  // online softmax: running max, sum and sum of P dP
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
            dp[nt][e] = __expf((s[nt][e] - m[e >> 1]) - ll[e >> 1]) * (dp[nt][e] - D[e >> 1]);
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
    if (step == steps - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (qi[r] >= p.Rq) continue;
        const long long row = gh * p.Rq + qi[r];
#pragma unroll
        for (int n = 0; n < NTD; ++n)
          *reinterpret_cast<__nv_bfloat162*>(dq + row * HD + n * 8 + 2 * t4) =
              __floats2bfloat162_rn(dqa[n][2 * r] * p.scale, dqa[n][2 * r + 1] * p.scale);
        if (t4 == 0) {
          lse_out[row] = m[r];
          lse_out[static_cast<long long>(p.heads) * p.G * p.Rq + row] = ll[r];
          d_out[row] = D[r];
        }
      }
    }
    __syncthreads();
  }
}

// Kernel 2: dk and dv of 64 key rows of a pair; query rows, g rows and their
// row max, log-sum and D stream through.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
masked_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ mask,
                          const bf16* __restrict__ gout, const float* __restrict__ lse_in,
                          const float* __restrict__ d_in, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, MaskedParams p, MaskedBwdTiling t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = mma_ld<HD>(), KS = HD / 16, NTD = HD / 8, TILE = kMmaRows * LD;
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [2][TILE], by unit
  bf16* sV = sK + 2 * TILE;                      // [2][TILE], by unit
  bf16* sQ = sV + 2 * TILE;                      // [2][TILE], by item
  bf16* sG = sQ + 2 * TILE;                      // [2][TILE], by item
  float* sX = reinterpret_cast<float*>(sG + 2 * TILE);  // [2][64] row max
  float* sL = sX + 2 * kMmaRows;                         // [2][64] log-sum
  float* sD = sL + 2 * kMmaRows;                         // [2][64] D
  float* sS = sD + 2 * kMmaRows;  // [Rq rounded up to 16, kMaskStripLd] if resident
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  const int nqt = (p.Rq + kMmaRows - 1) / kMmaRows;
  int u0, u1;
  unit_range(t.units, u0, u1);
  const int nitems = (u1 - u0) * nqt;  // (unit, query tile), query tiles fastest

  // q and g rows of the item's query tile with their row max, log-sum and D
  // (zero past Rq, where q and g rows are zero too), and the unit's k and v rows with
  // its first query tile
  auto stage = [&](int item) {
    const int ul = item / nqt, qt = item % nqt, u = u0 + ul;
    const int kt = u / (p.G * p.heads), g = (u / p.heads) % p.G, head = u % p.heads;
    const long long gh = static_cast<long long>(head) * p.G + g;
    if (qt == 0) {
      stage_dense<HD>(sK + (ul & 1) * TILE, k + gh * p.Rk * HD, kt * kMmaRows, kMmaRows, p.Rk);
      stage_dense<HD>(sV + (ul & 1) * TILE, v + gh * p.Rk * HD, kt * kMmaRows, kMmaRows, p.Rk);
    }
    const int i0 = qt * kMmaRows, buf = item & 1;
    stage_dense<HD>(sQ + buf * TILE, q + gh * p.Rq * HD, i0, kMmaRows, p.Rq);
    stage_dense<HD>(sG + buf * TILE, gout + gh * p.Rq * HD, i0, kMmaRows, p.Rq);
    const long long hgr = static_cast<long long>(p.heads) * p.G * p.Rq;
    for (int idx = threadIdx.x; idx < 3 * kMmaRows; idx += kMmaThreads) {
      const int which = idx / kMmaRows, r = idx % kMmaRows, i = i0 + r;
      const float* src = which == 2 ? d_in : lse_in + which * hgr;
      cp_async4(sX + which * 2 * kMmaRows + buf * kMmaRows + r,
                src + (i < p.Rq ? gh * p.Rq + i : 0), i < p.Rq);
    }
  };

  if (nitems > 0) stage(0);
  cp_async_commit();

  int staged = -1;  // mask class (kt, g % Gm) of the strip in sS
  const float* mb = mask;
  int kj[2] = {0, 0};
  uint32_t ka[KS][4], va[KS][4];
  float dka[NTD][4], dva[NTD][4];
  long long gh = 0;

  for (int it = 0; it < nitems; ++it) {
    const int ul = it / nqt, qt = it % nqt, u = u0 + ul;
    const int kt = u / (p.G * p.heads), g = (u / p.heads) % p.G, head = u % p.heads;
    if (qt == 0) {
      const int cls = kt * p.Gm + g % p.Gm;
      mb = mask + static_cast<long long>(g % p.Gm) * p.Rq * p.Rk;
      // the last reader of sS passed the barrier that ended the previous item
      if (t.resident && cls != staged) {
        stage_mask(sS, kMaskStripLd, mb, p.Rq, p.Rk, 0, (p.Rq + 15) / 16 * 16, kt * kMmaRows,
                   kMmaRows);
        staged = cls;
      }
      gh = static_cast<long long>(head) * p.G + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) kj[r] = kt * kMmaRows + warp * 16 + gq + 8 * r;
#pragma unroll
      for (int n = 0; n < NTD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
    }
    cp_async_commit();  // the strip, if staged: complete at the wait below
    if (it + 1 < nitems) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (qt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        load_a(ka[ks], sK + (ul & 1) * TILE, LD, warp * 16, ks * 16, lane);
        load_a(va[ks], sV + (ul & 1) * TILE, LD, warp * 16, ks * 16, lane);
      }
    }
    const bf16* tq = sQ + (it & 1) * TILE;
    const bf16* tg = sG + (it & 1) * TILE;
    const float* tx = sX + (it & 1) * kMmaRows;
    const float* tl = sL + (it & 1) * kMmaRows;
    const float* td = sD + (it & 1) * kMmaRows;
    const int i0 = qt * kMmaRows;
    for (int qc = 0; qc < kMmaRows / 16 && i0 + qc * 16 < p.Rq; ++qc) {
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
      // P^T and dS^T (rows: keys, columns: queries); the mask read at
      // mask[i][j]
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, il = qc * 16 + nt * 8 + 2 * t4 + (e & 1), i = i0 + il;
          float mv;
          if (t.resident)
            mv = sS[i * kMaskStripLd + warp * 16 + gq + 8 * r];
          else
            mv = i < p.Rq && kj[r] < p.Rk ? __ldg(mb + static_cast<long long>(i) * p.Rk + kj[r])
                                          : 0.f;
          const float pr =
              i < p.Rq ? __expf((fmaf(s[nt][e], p.scale, mv) - tx[il]) - tl[il]) : 0.f;
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
    if (qt == nqt - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (kj[r] >= p.Rk) continue;
        const long long off = (gh * p.Rk + kj[r]) * HD;
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
    __syncthreads();
  }
}

template <int HD>
int launch_bwd_mma(const void* q, const void* k, const void* v, const float* mask, const void* g,
                   void* dq, void* dk, void* dv, float* lse, float* dsum, MaskedParams p,
                   cudaStream_t stream) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* g_ = static_cast<const bf16*>(g);
  MaskedBwdTiling t1;
  t1.q_rows = masked_q_rows(p.Rq);
  t1.mask_ld = masked_mask_ld(p.Rk);
  MaskedBwdTiling t2 = t1;
  const long long units1 =
      static_cast<long long>((p.Rq + t1.q_rows - 1) / t1.q_rows) * p.G * p.heads;
  const long long units2 =
      static_cast<long long>((p.Rk + kMmaRows - 1) / kMmaRows) * p.G * p.heads;
  if (units1 > (1 << 30) || units2 > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  t1.units = static_cast<int>(units1);
  t2.units = static_cast<int>(units2);
  t1.resident = masked_dq_smem_bytes<HD>(t1, true) <= kMaxBlockSmem;
  t2.resident = masked_dkv_smem_bytes<HD>(p.Rq, true) <= kMaxBlockSmem;
  const int smem1 = static_cast<int>(masked_dq_smem_bytes<HD>(t1, t1.resident));
  const int smem2 = static_cast<int>(masked_dkv_smem_bytes<HD>(p.Rq, t2.resident));
  const int threads1 = t1.q_rows / 16 * 32;
  int blocks1 = 0, blocks2 = 0;
  cudaError_t err =
      launch_config(masked_bwd_dq_mma_kernel<HD>, threads1, smem1, t1.units, &blocks1);
  if (err == cudaSuccess)
    err = launch_config(masked_bwd_dkv_mma_kernel<HD>, kMmaThreads, smem2, t2.units, &blocks2);
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_bwd_dq_mma_kernel<HD><<<blocks1, threads1, smem1, stream>>>(
      q_, k_, v_, mask, g_, static_cast<bf16*>(dq), lse, dsum, p, t1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_bwd_dkv_mma_kernel<HD><<<blocks2, kMmaThreads, smem2, stream>>>(
      q_, k_, v_, mask, g_, lse, dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), p, t2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const float* mask, const void* g,
               void* dq, void* dk, void* dv, float* lse, float* dsum, MaskedParams p,
               cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_bwd_mma<HD>(q, k, v, mask, g, dq, dk, dv, lse, dsum, p, stream);
  } else {
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
}

template <typename T>
int dispatch_bwd(int hd, const void* q, const void* k, const void* v, const float* mask,
                 const void* g, void* dq, void* dk, void* dv, float* lse, float* dsum,
                 MaskedParams p, cudaStream_t s) {
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
  MaskedParams p;
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
