// Backward of the shifted-window NMP attention (K1b).
//
// Replaces nmrf_tpu/ops/pallas/attention.py:_wan_bwd_kernel_direct (and the
// transposed _wan_bwd_fused_kernel, which computes the same function),
// driven by window_attention_native_bwd / _wan_bwd_core.
//
// Function, per window and head, with the forward of window_attention.cu
// (logit[i,j] = scale q_i.k_j + qr[i,pix(j)] + kr[j,pix(i)] + masks,
// P = softmax_j(logit), out_i = sum_j P_ij v_j + sum_s mass(i,s) ve[pix(i),s])
// and g = dL/dout:
//   dP_ij  = g_i.v_j + gve[i,pix(j)],   gve[i,s] = g_i.ve[pix(i),s]
//   dS_ij  = P_ij (dP_ij - D_i),         D_i = sum_j P_ij dP_ij
//   dq_i   = scale sum_j dS_ij k_j       dk_j = scale sum_i dS_ij q_i
//   dv_j   = sum_i P_ij g_i
//   dqr[i,s] = sum_{j: pix(j)=s} dS_ij   dkr[j,p] = sum_{i: pix(i)=p} dS_ij
//   mass[i,s] = sum_{j: pix(j)=s} P_ij
//   d(ve)[h,p,s,c] = sum over every window and sample of
//                    sum_{i: pix(i)=p} mass(i,s) g_i[c]
// The shifted-region mask takes global rows, y = row0 + local y against the
// global padded height hp_total, as in the forward.
// dq/dk here are the content halves; the caller (ops/attention.py) adds the
// positional halves dqr.ke and dkr.qe and turns dqr/dkr into the q/k table
// rows with plain tensor products, as the JAX package leaves that einsum
// VJP to XLA.  d(qkv) is written in f32, dqr/dkr/mass as [G, h, T, P] f32.
//
// Design.  Kernel 1, one block of 8 warps per (group of windows, head), the
// grouping of the forward (one window at T >= 128, else floor(128 / T)
// windows per block):
//   1. q, k, v and g rows of the group go to shared memory in the input's
//      dtype; the head's qe|ke|ve table columns are staged once, and the
//      pixel-granular qr, kr and gve blocks [rows, P] are computed from them.
//   2. Row pass: a warp owns a query row; it recomputes the logits and the
//      f32 softmax, forms dP and dS in two per-warp shared rows, writes dq
//      (lanes own channels), dqr and mass (lanes own key pixels), and keeps
//      the row's log-sum-exp and D_i in shared memory.
//   3. Column pass: a warp owns a key row j; lanes walk the query rows of
//      its window, recompute P_ij = exp(logit_ij - lse_i) and dS_ij, and
//      the warp forms dk_j, dv_j and dkr[j, :].  The logits are computed
//      twice instead of keeping the T x T P and dS of a window (2 x 83 KB
//      in f32 at T = 144) beside the staged rows.
// Kernel 2, the d(ve) reduction: one block per (key-side pixel p, head)
// sums mass(i, s) g_i[c] over the tokens of pixel p in every window, 32
// tokens at a time through shared memory, in a fixed order.  Summing over
// the 1024 windows of a batch of 8 at Inference in one pass keeps no
// per-window partial (0.66 MB each) and no float atomics, so d(ve) is
// deterministic; it costs one f32 [G, h, T, P] mass buffer (85 MB at
// Inference, batch 8) that the row pass writes and kernel 2 reads.
// Softmax and every sum are f32, for f32 and bf16 inputs alike.
//
// Bound on the H100 (bf16, training shape 48x96, batch 8, Inference): the
// launch must read qkv, g and the table and write d(qkv), dqr, dkr and
// d(ve) (about 0.7 GB with the f32 outputs) and do about 2.5x the forward's
// matrix work; the bytes bound it.  This version does its dot products on
// CUDA cores from shared memory and recomputes the logits once more, so it
// is issue-bound far above that; mma/wgmma tiles are the next step.

#include "common.cuh"

namespace nmrf {

struct WindowBwdParams {
  int B, Hp, Wp, N, C, heads, wh, ww, shift, candidate_mask, wpb, nwin;
  int row0, hp_total;  // global row of local row 0; global padded height
  float scale;
};

constexpr int kBwdWarps = 8;
constexpr int kDveThreads = 256;
constexpr int kDveItems = 32;

__device__ __forceinline__ int rel_row(int p, int s, int wh, int ww) {
  const int py = p / ww, px = p % ww, sy = s / ww, sx = s % ww;
  return (py - sy + wh - 1) * (2 * ww - 1) + (px - sx + ww - 1);
}

// row stride of the staged rows: an odd number of 32-bit words
template <typename T, int HD>
__host__ __device__ constexpr int bwd_row_stride() { return sizeof(T) == 4 ? HD + 1 : HD + 2; }

template <typename T, int HD>
inline size_t window_bwd_smem_bytes(int rows, int P, int Tw, int trows) {
  const size_t tok = static_cast<size_t>(4) * rows * bwd_row_stride<T, HD>() * sizeof(T);
  const size_t tok_aligned = (tok + 15) / 16 * 16;
  const size_t pos = (static_cast<size_t>(3) * rows * P + 2 * rows) * sizeof(float);
  const size_t scratch_rows = static_cast<size_t>(kBwdWarps) * 2 * Tw;
  const size_t scratch_tbl = static_cast<size_t>(trows) * (3 * HD + 1);
  return tok_aligned + pos +
         sizeof(float) * (scratch_rows > scratch_tbl ? scratch_rows : scratch_tbl);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdWarps * 32)
window_attention_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ table,
                            const T* __restrict__ gout, float* __restrict__ dqkv,
                            float* __restrict__ dqr, float* __restrict__ dkr,
                            float* __restrict__ mass, WindowBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = bwd_row_stride<T, HD>();
  constexpr int TS = 3 * HD + 1;  // staged table row stride (qe | ke | ve), odd
  constexpr int NC = (HD + 31) / 32;  // channels per lane
  const int P = p.wh * p.ww;
  const int Tw = P * p.N;
  const int rows = p.wpb * Tw;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  const int C3 = 3 * p.C;
  T* sq = reinterpret_cast<T*>(smem_raw);  // [rows, RS]
  T* sk = sq + rows * RS;
  T* sv = sk + rows * RS;
  T* sg = sv + rows * RS;
  const size_t tok_bytes = (static_cast<size_t>(4) * rows * RS * sizeof(T) + 15) / 16 * 16;
  float* sqr = reinterpret_cast<float*>(smem_raw + tok_bytes);  // [rows, P]
  float* skr = sqr + rows * P;                                  // [rows, P]
  float* sgve = skr + rows * P;                                 // [rows, P]
  float* slse = sgve + rows * P;                                // [rows]
  float* sD = slse + rows;                                      // [rows]
  float* scratch = sD + rows;  // staged table, then two rows per warp

  const int head = blockIdx.y;
  const int nwh = p.Hp / p.wh, nww = p.Wp / p.ww;
  const int tcol = head * 3 * HD;

  auto token_of = [&](int r) -> long long {
    const int win = blockIdx.x * p.wpb + r / Tw;
    if (win >= p.nwin) return -1;
    const int t = r % Tw;
    const int b = win / (nwh * nww), rem = win % (nwh * nww);
    const int y = (rem / nww) * p.wh + (t / p.N) / p.ww;
    const int x = (rem % nww) * p.ww + (t / p.N) % p.ww;
    return ((static_cast<long long>(b) * p.Hp + y) * p.Wp + x) * p.N + t % p.N;
  };

  for (int idx = threadIdx.x; idx < rows * HD; idx += blockDim.x) {
    const int r = idx / HD, c = idx % HD;
    const long long tok = token_of(r);
    T qv = from_float<T>(0.f), kv = qv, vv = qv, gv = qv;
    if (tok >= 0) {
      const T* src = qkv + tok * C3 + head * HD + c;
      qv = src[0];
      kv = src[p.C];
      vv = src[2 * p.C];
      gv = gout[tok * p.C + head * HD + c];
    }
    sq[r * RS + c] = qv;
    sk[r * RS + c] = kv;
    sv[r * RS + c] = vv;
    sg[r * RS + c] = gv;
  }
  for (int idx = threadIdx.x; idx < trows * 3 * HD; idx += blockDim.x) {
    const int t = idx / (3 * HD), c = idx % (3 * HD);
    scratch[t * TS + c] = __ldg(table + static_cast<long long>(t) * C3 + tcol + c);
  }
  __syncthreads();

  // pixel-granular positional blocks: qr and kr with the scale folded in,
  // and gve[r, s] = g_r . ve[rel(pix(r), s)]
  for (int idx = threadIdx.x; idx < rows * P; idx += blockDim.x) {
    const int r = idx / P, s = idx % P;
    const int pix = (r % Tw) / p.N;
    const float* qe = scratch + rel_row(s, pix, p.wh, p.ww) * TS;
    const float* kve = scratch + rel_row(pix, s, p.wh, p.ww) * TS;
    const T* qrow = sq + r * RS;
    const T* krow = sk + r * RS;
    const T* grow = sg + r * RS;
    float aq = 0.f, ak = 0.f, ag = 0.f;
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      aq += to_float(qrow[c]) * kve[HD + c];
      ak += to_float(krow[c]) * qe[c];
      ag += to_float(grow[c]) * kve[2 * HD + c];
    }
    sqr[r * P + s] = aq * p.scale;
    skr[r * P + s] = ak * p.scale;
    sgve[r * P + s] = ag;
  }
  __syncthreads();  // the staged table is dead from here

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* prow = scratch + warp * 2 * Tw;  // probabilities of one row/column
  float* drow = prow + Tw;                // dS of one row/column

  auto region_of = [&](int win, int t) {
    const int rem = win % (nwh * nww);
    const int y = p.row0 + (rem / nww) * p.wh + (t / p.N) / p.ww;  // global row
    const int x = (rem % nww) * p.ww + (t / p.N) % p.ww;
    const int ry = (y >= p.hp_total - p.wh) + (y >= p.hp_total - p.shift);
    const int rx = (x >= p.Wp - p.ww) + (x >= p.Wp - p.shift);
    return 3 * ry + rx;
  };
  // additive mask of (query token ti, key token tj) of one window
  auto masked = [&](int win, int ti, int tj, int reg_fixed, bool fixed_is_query) {
    if (p.candidate_mask && ti / p.N == tj / p.N && ti != tj) return true;
    if (p.shift > 0) {
      const int other = region_of(win, fixed_is_query ? tj : ti);
      if (other != reg_fixed) return true;
    }
    return false;
  };

  // ---- row pass: softmax, dP, dS, dq, dqr, mass, lse, D ----
  for (int r = warp; r < rows; r += kBwdWarps) {
    const long long tok = token_of(r);
    if (tok < 0) break;  // rows past the window count are all at the end
    const int base = (r / Tw) * Tw;
    const int ti = r % Tw;
    const int pix_i = ti / p.N;
    const int win = blockIdx.x * p.wpb + r / Tw;
    const int reg_i = p.shift > 0 ? region_of(win, ti) : 0;
    float qi[HD], gi[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      qi[c] = to_float(sq[r * RS + c]);
      gi[c] = to_float(sg[r * RS + c]);
    }
    float mx = -INFINITY;
    for (int j = lane; j < Tw; j += 32) {
      const T* kj = sk + (base + j) * RS;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) s += qi[c] * to_float(kj[c]);
      s = s * p.scale + sqr[r * P + j / p.N] + skr[(base + j) * P + pix_i];
      if (masked(win, ti, j, reg_i, true)) s += kNegInf;
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Tw; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float inv = 1.f / sum;
    float dsum = 0.f;
    for (int j = lane; j < Tw; j += 32) {
      const T* vj = sv + (base + j) * RS;
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) dp += gi[c] * to_float(vj[c]);
      dp += sgve[r * P + j / p.N];
      const float pr = prow[j] * inv;
      prow[j] = pr;
      drow[j] = dp;
      dsum += pr * dp;
    }
    const float D = warp_sum(dsum);
    for (int j = lane; j < Tw; j += 32) drow[j] = prow[j] * (drow[j] - D);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = k * 32 + lane;
      if (c < HD) {
        float a0 = 0.f, a1 = 0.f;
        const T* kc = sk + base * RS + c;
        int j = 0;
        for (; j + 2 <= Tw; j += 2) {
          a0 += drow[j] * to_float(kc[j * RS]);
          a1 += drow[j + 1] * to_float(kc[(j + 1) * RS]);
        }
        for (; j < Tw; ++j) a0 += drow[j] * to_float(kc[j * RS]);
        dqkv[tok * C3 + head * HD + c] = (a0 + a1) * p.scale;
      }
    }
    const long long out_row = (static_cast<long long>(win) * p.heads + head) * Tw + ti;
    for (int s = lane; s < P; s += 32) {
      float ds = 0.f, m = 0.f;
      for (int n = 0; n < p.N; ++n) {
        ds += drow[s * p.N + n];
        m += prow[s * p.N + n];
      }
      dqr[out_row * P + s] = ds;
      mass[out_row * P + s] = m;
    }
    if (lane == 0) {
      slse[r] = mx + logf(sum);
      sD[r] = D;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- column pass: dk, dv, dkr of key row r ----
  for (int r = warp; r < rows; r += kBwdWarps) {
    const long long tok = token_of(r);
    if (tok < 0) break;
    const int base = (r / Tw) * Tw;
    const int tj = r % Tw;
    const int pix_j = tj / p.N;
    const int win = blockIdx.x * p.wpb + r / Tw;
    const int reg_j = p.shift > 0 ? region_of(win, tj) : 0;
    float kj[HD], vj[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      kj[c] = to_float(sk[r * RS + c]);
      vj[c] = to_float(sv[r * RS + c]);
    }
    for (int i = lane; i < Tw; i += 32) {
      const int ri = base + i;
      const T* qi = sq + ri * RS;
      const T* gi = sg + ri * RS;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        s += to_float(qi[c]) * kj[c];
        dp += to_float(gi[c]) * vj[c];
      }
      s = s * p.scale + sqr[ri * P + pix_j] + skr[r * P + i / p.N];
      if (masked(win, i, tj, reg_j, false)) s += kNegInf;
      const float pr = expf(s - slse[ri]);
      dp += sgve[ri * P + pix_j];
      prow[i] = pr;
      drow[i] = pr * (dp - sD[ri]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = k * 32 + lane;
      if (c < HD) {
        float dk = 0.f, dv = 0.f;
        const T* qc = sq + base * RS + c;
        const T* gc = sg + base * RS + c;
        for (int i = 0; i < Tw; ++i) {
          dk += drow[i] * to_float(qc[i * RS]);
          dv += prow[i] * to_float(gc[i * RS]);
        }
        dqkv[tok * C3 + p.C + head * HD + c] = dk * p.scale;
        dqkv[tok * C3 + 2 * p.C + head * HD + c] = dv;
      }
    }
    const long long out_row = (static_cast<long long>(win) * p.heads + head) * Tw + tj;
    for (int q = lane; q < P; q += 32) {
      float ds = 0.f;
      for (int n = 0; n < p.N; ++n) ds += drow[q * p.N + n];
      dkr[out_row * P + q] = ds;
    }
    __syncwarp();
  }
}

// d(ve)[head, pix, s, c] = sum over windows w and candidates n of
// mass[w, head, (pix, n), s] * g[token (w, pix, n), head, c]
template <typename T, int HD>
__global__ void __launch_bounds__(kDveThreads)
window_dve_kernel(const T* __restrict__ gout, const float* __restrict__ mass,
                  float* __restrict__ dve, WindowBwdParams p) {
  constexpr int MAXO = (64 * HD + kDveThreads - 1) / kDveThreads;  // P <= 64
  __shared__ float sm[kDveItems][65];
  __shared__ float sgr[kDveItems][HD + 1];
  const int pix = blockIdx.x, head = blockIdx.y;
  const int P = p.wh * p.ww;
  const int Tw = P * p.N;
  const int nwh = p.Hp / p.wh, nww = p.Wp / p.ww;
  const int items = p.nwin * p.N;
  float acc[MAXO];
#pragma unroll
  for (int k = 0; k < MAXO; ++k) acc[k] = 0.f;
  for (int it0 = 0; it0 < items; it0 += kDveItems) {
    const int nit = min(kDveItems, items - it0);
    for (int idx = threadIdx.x; idx < nit * P; idx += blockDim.x) {
      const int it = idx / P, s = idx % P;
      const int win = (it0 + it) / p.N, t = pix * p.N + (it0 + it) % p.N;
      sm[it][s] = mass[((static_cast<long long>(win) * p.heads + head) * Tw + t) * P + s];
    }
    for (int idx = threadIdx.x; idx < nit * HD; idx += blockDim.x) {
      const int it = idx / HD, c = idx % HD;
      const int win = (it0 + it) / p.N, n = (it0 + it) % p.N;
      const int b = win / (nwh * nww), rem = win % (nwh * nww);
      const int y = (rem / nww) * p.wh + pix / p.ww;
      const int x = (rem % nww) * p.ww + pix % p.ww;
      const long long tok = ((static_cast<long long>(b) * p.Hp + y) * p.Wp + x) * p.N + n;
      sgr[it][c] = to_float(gout[tok * p.C + head * HD + c]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAXO; ++k) {
      const int o = k * kDveThreads + threadIdx.x;
      if (o < P * HD) {
        const int s = o / HD, c = o % HD;
        float a = acc[k];
        for (int it = 0; it < nit; ++it) a += sm[it][s] * sgr[it][c];
        acc[k] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < MAXO; ++k) {
    const int o = k * kDveThreads + threadIdx.x;
    if (o < P * HD) dve[(static_cast<long long>(head) * P + pix) * P * HD + o] = acc[k];
  }
}

template <typename T, int HD>
int launch_bwd(const void* qkv, const float* table, const void* g, float* dqkv, float* dqr,
               float* dkr, float* mass, float* dve, WindowBwdParams p, cudaStream_t stream) {
  const int P = p.wh * p.ww;
  const int Tw = P * p.N;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  const size_t smem = window_bwd_smem_bytes<T, HD>(p.wpb * Tw, P, Tw, trows);
  cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nwin + p.wpb - 1) / p.wpb, p.heads);
  window_attention_bwd_kernel<T, HD><<<grid, kBwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), table, static_cast<const T*>(g), dqkv, dqr, dkr, mass, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_dve_kernel<T, HD><<<dim3(P, p.heads), kDveThreads, 0, stream>>>(
      static_cast<const T*>(g), mass, dve, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(int hd, const void* qkv, const float* table, const void* g, float* dqkv,
                 float* dqr, float* dkr, float* mass, float* dve, WindowBwdParams p,
                 cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(qkv, table, g, dqkv, dqr, dkr, mass, dve, p, s);
    case 32: return launch_bwd<T, 32>(qkv, table, g, dqkv, dqr, dkr, mass, dve, p, s);
    case 64: return launch_bwd<T, 64>(qkv, table, g, dqkv, dqr, dkr, mass, dve, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nmrf

extern "C" int nmrf_window_attention_bwd(const void* qkv, const void* table, const void* g,
                                         void* dqkv, void* dqr, void* dkr, void* mass,
                                         void* dve, int dtype, int B, int Hp, int Wp, int N,
                                         int C, int heads, int wh, int ww, int shift,
                                         int candidate_mask, int row0, int hp_total,
                                         float scale, void* stream) {
  using namespace nmrf;
  WindowBwdParams p;
  p.B = B; p.Hp = Hp; p.Wp = Wp; p.N = N; p.C = C; p.heads = heads;
  p.wh = wh; p.ww = ww; p.shift = shift;
  p.candidate_mask = candidate_mask; p.scale = scale;
  p.row0 = row0; p.hp_total = hp_total;
  const int Tw = wh * ww * N;
  if (wh * ww > 64) return static_cast<int>(cudaErrorInvalidValue);  // P <= 64
  p.wpb = Tw >= 128 ? 1 : 128 / Tw;
  p.nwin = B * (Hp / wh) * (Wp / ww);
  const float* tbl = static_cast<const float*>(table);
  float* out[5] = {static_cast<float*>(dqkv), static_cast<float*>(dqr),
                   static_cast<float*>(dkr), static_cast<float*>(mass),
                   static_cast<float*>(dve)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_bwd<float>(C / heads, qkv, tbl, g, out[0], out[1], out[2], out[3], out[4], p, s);
  if (dtype == kBF16)
    return dispatch_bwd<__nv_bfloat16>(C / heads, qkv, tbl, g, out[0], out[1], out[2], out[3],
                                       out[4], p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
