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
// Design.  Three kernels, one launch:
//   Kernel 1, one block per (group of windows, head), the grouping of the
//   forward (one window at T >= 128, else floor(128 / T) windows per block):
//   the softmax backward, dq, dk, dv, dqr, dkr and mass.
//   Kernel 2, the d(ve) reduction over a fixed grid of (key-side pixel p,
//   head, split) blocks: split s sums mass(i, s') g_i[c] over its share of
//   the (window, candidate) items of pixel p, 32 at a time through shared
//   memory in a fixed order, into its own f32 partial; the number of splits
//   is a function of the shapes only (the wrapper's), about 8 blocks per SM.
//   Kernel 3 sums the partials in split order.  No float atomics anywhere:
//   every output element has one owner or is summed from fixed-order
//   partials, so two launches on the same inputs give the same bits.  The
//   f32 [G, h, T, P] mass buffer (85 MB at Inference, batch 8) is what
//   kernel 1 writes and kernel 2 reads.
//
// Kernel 1 in bf16, the training step's launch, at T = 16 (Refinement) and
// T = 144 (Inference) with N in {1, 2, 4, 8}: the products run on the tensor
// cores, mma.sync.m16n8k16 with bf16 operands and f32 accumulation, fed by
// ldmatrix; one warp per 16 query rows (9 warps at Inference, 8 windows of
// one warp each at Refinement).
//   1. The pixel token and shifted region of every row are computed once;
//      q, k, v and g rows of the group go to shared memory with 16-byte
//      cp.async, rows padded to HD + 8 elements (no ldmatrix bank
//      conflict); the head's qe | ke | ve table columns are staged as bf16
//      (the table holds bf16 values, so exactly).
//   2. The positional blocks qr, kr and gve [rows, P] (f32 in shared
//      memory) are three small products on the tensor cores: Q, K and G
//      against every table row, each result scattered to the pixel s with
//      rel(pix(i), s), or rel(s, pix(i)) for kr, equal to that table row.
//   3. Row pass, one warp per 16 query rows, in three sweeps over 16-key
//      chunks: S = Q K^T with the positional terms and both masks added in
//      the fragment, for the row's f32 max and sum (online, quad shuffles);
//      again for P, mass and D = sum_j P_ij (dP_ij), dP = G V^T + gve; again
//      for dS = P (dP - D), dqr, dkr and dq += dS K, dS reused as the A
//      fragment.  The logits are recomputed instead of held: a 16 x 144 row
//      block in registers (72 per thread) spilled under the 168 registers a
//      thread of a 9-warp block may have (the SM's four register files hold
//      3 of its warps each).  dqr and mass sum the N adjacent key columns of
//      a pixel with shuffles inside the quad, dkr the N query rows of a pixel
//      with shuffles across the lanes that hold them.  P and dS of the
//      window are kept in shared memory as bf16 (2 x 41.5 KB at T = 144).
//   4. Column pass, one warp per 16 key rows: dk = dS^T Q and dv = P^T G
//      from the kept P and dS by ldmatrix.trans, no logit recomputed.
// Shared memory at Inference (hd 32): 46 KB of rows, 62 KB of f32
// positional blocks, 86 KB of P and dS: one block of 9 warps per SM.
// Softmax, lse, D, dqr, dkr, mass and the d(ve) sums stay in f32; P and dS
// are rounded to bf16 only as mma operands, as FlashAttention-2 does.  wgmma
// is not needed: the work is bound by bytes, a Refinement window is a single
// 16-row tile and hd 32 is two k-steps, so mma.sync tiles suffice.
// Kernel 1 in f32 (the phase 3 and 4 checks at 1e-4, which TF32 would not
// meet) and in bf16 at other window shapes: the CUDA-core version, 8 warps,
// a row pass (a warp per query row: logits, softmax, dP and dS in two
// per-warp shared rows, dq, dqr and mass) and a column pass (a warp per key
// row: the logits recomputed, dk, dv and dkr), every product in f32 from
// shared memory.
//
// Bound on the H100 (bf16, training shape 48x96, batch 8, Inference): the
// launch must read qkv, g and the table and write d(qkv), dqr, dkr and
// d(ve) (about 0.7 GB with the f32 outputs) and do about 2.5x the forward's
// matrix work; the bytes bound it.  The bf16 kernel 1 stays far above that
// (PERF.md); what holds it is not measured (ncu does not run on the card's
// machine): the candidates are one block per SM at Inference, which leaves
// a block's loads, sweeps and writes unoverlapped, and the elementwise part
// of the sweeps (positional terms and masks from shared memory, exp, the
// pixel sums).

#include "common.cuh"
#include "mma.cuh"

namespace nmrf {

struct WindowBwdParams {
  int B, Hp, Wp, N, C, heads, wh, ww, shift, candidate_mask, wpb, nwin;
  int row0, hp_total;  // global row of local row 0; global padded height
  int nsplit;          // splits of the d(ve) items (kernel 2's grid)
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

// ---------------------------------------------------------------------------
// Kernel 1 in bf16: tensor-core row and column passes
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaMaxWarps = 9;  // one warp per 16 rows of a window group

template <int HD>
__host__ __device__ constexpr int wmma_ld() { return HD + 8; }  // padded staged row

// byte offsets of the bf16 kernel's shared memory: q|k|v|g rows, then the
// f32 qr|kr|gve blocks, then one region that holds the staged table and
// later P|dS of every window, then the token and region ids; returns the
// total
template <int HD>
__host__ __device__ inline size_t wmma_smem(int rows, int P, int T, int wpb, int trows,
                                            size_t* pos_off, size_t* x_off, size_t* int_off) {
  const size_t tok = static_cast<size_t>(4) * rows * wmma_ld<HD>() * sizeof(bf16);
  const size_t pos = static_cast<size_t>(3) * rows * P * sizeof(float);
  const size_t pds = static_cast<size_t>(2) * wpb * T * (T + 8) * sizeof(bf16);
  const size_t tbl = static_cast<size_t>((trows + 15) / 16 * 16) * (3 * HD + 8) * sizeof(bf16);
  *pos_off = tok;
  *x_off = tok + pos;
  *int_off = *x_off + (pds > tbl ? pds : tbl);
  return *int_off + static_cast<size_t>(2) * rows * sizeof(int);
}

// MT 16-row tiles per window (T = 16 MT); N = 1 << nshift candidates
template <int HD, int MT>
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
window_bwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ table,
                      const bf16* __restrict__ gout, float* __restrict__ dqkv,
                      float* __restrict__ dqr, float* __restrict__ dkr,
                      float* __restrict__ mass, WindowBwdParams p, int nshift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int T = 16 * MT, NT = 2 * MT, LD = wmma_ld<HD>(), KS = HD / 16, NTD = HD / 8;
  constexpr int TS = 3 * HD + 8;  // staged table row (qe | ke | ve)
  constexpr int PL = T + 8;       // kept P / dS row
  const int P = p.wh * p.ww;
  const int rows = p.wpb * T;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  const int TR = (trows + 15) / 16 * 16;
  const int C3 = 3 * p.C;
  size_t pos_off, x_off, int_off;
  wmma_smem<HD>(rows, P, T, p.wpb, trows, &pos_off, &x_off, &int_off);
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [rows, LD] each
  bf16* sk = sq + rows * LD;
  bf16* sv = sk + rows * LD;
  bf16* sg = sv + rows * LD;
  float* sqr = reinterpret_cast<float*>(smem_raw + pos_off);  // [rows, P] each
  float* skr = sqr + rows * P;
  float* sgve = skr + rows * P;
  bf16* sx = reinterpret_cast<bf16*>(smem_raw + x_off);  // table [TR, TS], then P|dS
  int* stok = reinterpret_cast<int*>(smem_raw + int_off);  // token of each row, -1 past nwin
  int* sreg = stok + rows;                                 // shifted region of each row

  const int head = blockIdx.y;
  const int nwh = p.Hp / p.wh, nww = p.Wp / p.ww;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  const int win0 = blockIdx.x * p.wpb;

  // ---- 1. token and region ids, the staged table, the q|k|v|g rows ----
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int win = win0 + r / T, t = r % T;
    int tok = -1, reg = 0;
    if (win < p.nwin) {
      const int b = win / (nwh * nww), rem = win % (nwh * nww);
      const int y = (rem / nww) * p.wh + (t / p.N) / p.ww;
      const int x = (rem % nww) * p.ww + (t / p.N) % p.ww;
      tok = ((b * p.Hp + y) * p.Wp + x) * p.N + t % p.N;
      if (p.shift > 0) {
        const int gy = p.row0 + y;  // global row
        const int ry = (gy >= p.hp_total - p.wh) + (gy >= p.hp_total - p.shift);
        const int rx = (x >= p.Wp - p.ww) + (x >= p.Wp - p.shift);
        reg = 3 * ry + rx;
      }
    }
    stok[r] = tok;
    sreg[r] = reg;
  }
  for (int idx = threadIdx.x; idx < TR * 3 * HD; idx += blockDim.x) {
    const int t = idx / (3 * HD), c = idx % (3 * HD);
    const float x = t < trows ? __ldg(table + static_cast<long long>(t) * C3 + head * 3 * HD + c)
                              : 0.f;
    sx[t * TS + c] = __float2bfloat16(x);
  }
  __syncthreads();
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int tok = stok[r];
    const bool valid = tok >= 0;
    const long long src = valid ? static_cast<long long>(tok) * C3 + head * HD + c : 0;
    const long long gsrc = valid ? static_cast<long long>(tok) * p.C + head * HD + c : 0;
    cp_async16(sq + r * LD + c, qkv + src, valid);
    cp_async16(sk + r * LD + c, qkv + src + p.C, valid);
    cp_async16(sv + r * LD + c, qkv + src + 2 * p.C, valid);
    cp_async16(sg + r * LD + c, gout + gsrc, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp: rows r0w.. of window wi of the group, its row tile rt
  const int r0w = warp * 16, wi = warp / MT, rt = warp % MT;
  const bool wvalid = win0 + wi < p.nwin;
  const int base = wi * T;  // group row of the window's token 0
  int ti[2], ri[2], pr[2];  // the thread's two rows: token in window, group row, pixel
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ti[r] = rt * 16 + gq + 8 * r;
    ri[r] = base + ti[r];
    pr[r] = ti[r] >> nshift;
  }

  // ---- 2. positional blocks: Q, K and G against every table row ----
  {
    uint32_t qa[KS][4], ka[KS][4], ga[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      load_a(qa[ks], sq, LD, r0w, ks * 16, lane);
      load_a(ka[ks], sk, LD, r0w, ks * 16, lane);
      load_a(ga[ks], sg, LD, r0w, ks * 16, lane);
    }
    const int W2 = 2 * p.ww - 1;
    for (int tp = 0; tp < TR / 16; ++tp) {
      float cq[2][4] = {}, ck[2][4] = {}, cg[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        load_b_rows(b, sx + HD, TS, tp * 16, ks * 16, lane);  // ke columns
        mma_bf16(cq[0], qa[ks], b[0], b[1]);
        mma_bf16(cq[1], qa[ks], b[2], b[3]);
        load_b_rows(b, sx, TS, tp * 16, ks * 16, lane);  // qe columns
        mma_bf16(ck[0], ka[ks], b[0], b[1]);
        mma_bf16(ck[1], ka[ks], b[2], b[3]);
        load_b_rows(b, sx + 2 * HD, TS, tp * 16, ks * 16, lane);  // ve columns
        mma_bf16(cg[0], ga[ks], b[0], b[1]);
        mma_bf16(cg[1], ga[ks], b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = tp * 16 + nt * 8 + 2 * t4 + (e & 1), r = e >> 1;
          if (t >= trows) continue;
          const int dy = t / W2, dx = t - dy * W2;
          const int py = pr[r] / p.ww, px = pr[r] - py * p.ww;
          const int row = r0w + gq + 8 * r;
          // t = rel(pix, s): qr and gve
          int sy = py + p.wh - 1 - dy, sxx = px + p.ww - 1 - dx;
          if (sy >= 0 && sy < p.wh && sxx >= 0 && sxx < p.ww) {
            sqr[row * P + sy * p.ww + sxx] = cq[nt][e] * p.scale;
            sgve[row * P + sy * p.ww + sxx] = cg[nt][e];
          }
          // t = rel(s, pix): kr
          sy = py - p.wh + 1 + dy;
          sxx = px - p.ww + 1 + dx;
          if (sy >= 0 && sy < p.wh && sxx >= 0 && sxx < p.ww)
            skr[row * P + sy * p.ww + sxx] = ck[nt][e] * p.scale;
        }
    }
  }
  __syncthreads();  // the staged table is dead: its space keeps P | dS

  bf16* sP = sx + wi * 2 * T * PL;  // [T, PL] probabilities of the window
  bf16* sdS = sP + T * PL;          // [T, PL] dS of the window
  const bf16* wq = sq + base * LD;
  const bf16* wk = sk + base * LD;
  const bf16* wv = sv + base * LD;
  const bf16* wg = sg + base * LD;
  const long long orow = (static_cast<long long>(win0 + wi) * p.heads + head) * T;

  // ---- 3. row pass: three sweeps over 16-key chunks ----
  if (wvalid) {
    uint32_t qa[KS][4], ga[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      load_a(qa[ks], sq, LD, r0w, ks * 16, lane);
      load_a(ga[ks], sg, LD, r0w, ks * 16, lane);
    }
    // logits of keys kp*16..: scale Q K^T + qr[i, pix(j)] + kr[j, pix(i)] + masks
    auto logit_chunk = [&](float s[2][4], int kp) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        load_b_rows(b, wk, LD, kp * 16, ks * 16, lane);
        mma_bf16(s[0], qa[ks], b[0], b[1]);
        mma_bf16(s[1], qa[ks], b[2], b[3]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = kp * 16 + c * 8 + 2 * t4 + (e & 1), pj = j >> nshift;
          float x = s[c][e] * p.scale + sqr[ri[r] * P + pj] + skr[(base + j) * P + pr[r]];
          if ((p.candidate_mask && pj == pr[r] && j != ti[r]) ||
              (p.shift > 0 && sreg[ri[r]] != sreg[base + j]))
            x += kNegInf;
          s[c][e] = x;
        }
    };
    // dP of keys kp*16..: G V^T + gve[i, pix(j)]
    auto dp_chunk = [&](float dp[2][4], int kp) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[c][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        load_b_rows(b, wv, LD, kp * 16, ks * 16, lane);
        mma_bf16(dp[0], ga[ks], b[0], b[1]);
        mma_bf16(dp[1], ga[ks], b[2], b[3]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kp * 16 + c * 8 + 2 * t4 + (e & 1);
          dp[c][e] += sgve[ri[e >> 1] * P + (j >> nshift)];
        }
    };
    // sweep 1: the row's max and sum (online, f32)
    float mx[2] = {-INFINITY, -INFINITY}, inv[2] = {0.f, 0.f};
    for (int kp = 0; kp < MT; ++kp) {
      float s[2][4];
      logit_chunk(s, kp);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(mx[r], quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                                     fmaxf(s[1][2 * r], s[1][2 * r + 1]))));
        inv[r] *= __expf(mx[r] - mn);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          inv[r] += __expf(s[c][2 * r] - mn) + __expf(s[c][2 * r + 1] - mn);
        mx[r] = mn;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(inv[r]);
    const int ncol = 1 << nshift;  // key tokens of a pixel
    // sweep 2: P (to shared memory as bf16), mass, D = sum_j P dP
    float D[2] = {0.f, 0.f};
    for (int kp = 0; kp < MT; ++kp) {
      float s[2][4], dp[2][4];
      logit_chunk(s, kp);
      dp_chunk(dp, kp);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j0 = kp * 16 + c * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[c][e] = __expf(s[c][e] - mx[e >> 1]) * inv[e >> 1];
          D[e >> 1] += s[c][e] * dp[c][e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<uint32_t*>(sP + ti[r] * PL + j0) =
              pack_bf16(s[c][2 * r], s[c][2 * r + 1]);
          // mass: sums over the key tokens of each pixel
          if (ncol == 1) {
            mass[(orow + ti[r]) * P + j0] = s[c][2 * r];
            mass[(orow + ti[r]) * P + j0 + 1] = s[c][2 * r + 1];
          } else {
            float m = s[c][2 * r] + s[c][2 * r + 1];
            for (int o = 1; o < ncol / 2; o <<= 1) m += __shfl_xor_sync(0xffffffffu, m, o);
            if ((t4 & (ncol / 2 - 1)) == 0) mass[(orow + ti[r]) * P + (j0 >> nshift)] = m;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) D[r] = quad_sum(D[r]);

    // sweep 3: dS = P (dP - D) (to shared memory as bf16), dqr, dkr, dq
    float dqa[NTD][4];
#pragma unroll
    for (int n = 0; n < NTD; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
    for (int kp = 0; kp < MT; ++kp) {
      float s[2][4], ds[2][4];
      logit_chunk(s, kp);
      dp_chunk(ds, kp);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j0 = kp * 16 + c * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[c][e] = __expf(s[c][e] - mx[e >> 1]) * inv[e >> 1] * (ds[c][e] - D[e >> 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<uint32_t*>(sdS + ti[r] * PL + j0) =
              pack_bf16(ds[c][2 * r], ds[c][2 * r + 1]);
          // dqr: sums over the key tokens of each pixel
          if (ncol == 1) {
            dqr[(orow + ti[r]) * P + j0] = ds[c][2 * r];
            dqr[(orow + ti[r]) * P + j0 + 1] = ds[c][2 * r + 1];
          } else {
            float a = ds[c][2 * r] + ds[c][2 * r + 1];
            for (int o = 1; o < ncol / 2; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
            if ((t4 & (ncol / 2 - 1)) == 0) dqr[(orow + ti[r]) * P + (j0 >> nshift)] = a;
          }
        }
        // dkr: sums over the query tokens of the row's pixel (lanes gq ^ 1, 2, 4)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a = ds[c][e];
          for (int o = 4; o < (4 << nshift); o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
          if ((gq & (ncol - 1)) == 0) dkr[(orow + j0 + (e & 1)) * P + pr[e >> 1]] = a;
        }
      }
      uint32_t a[4];
      c_to_a(a, ds[0], ds[1]);
#pragma unroll
      for (int nd = 0; nd < NTD / 2; ++nd) {
        uint32_t b[4];
        load_b_cols(b, wk, LD, kp * 16, nd * 16, lane);
        mma_bf16(dqa[2 * nd], a, b[0], b[1]);
        mma_bf16(dqa[2 * nd + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* dst = dqkv + static_cast<long long>(stok[ri[r]]) * C3 + head * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < NTD; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(dqa[n][2 * r] * p.scale, dqa[n][2 * r + 1] * p.scale);
    }
  }
  __syncthreads();

  // ---- 4. column pass: dk = dS^T Q, dv = P^T G for the warp's 16 keys ----
  if (wvalid) {
    float dka[NTD][4], dva[NTD][4];
#pragma unroll
    for (int n = 0; n < NTD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
#pragma unroll
    for (int qc = 0; qc < MT; ++qc) {
      uint32_t da[4], pa[4];
      load_a_trans(da, sdS, PL, rt * 16, qc * 16, lane);
      load_a_trans(pa, sP, PL, rt * 16, qc * 16, lane);
#pragma unroll
      for (int nd = 0; nd < NTD / 2; ++nd) {
        uint32_t b[4];
        load_b_cols(b, wq, LD, qc * 16, nd * 16, lane);
        mma_bf16(dka[2 * nd], da, b[0], b[1]);
        mma_bf16(dka[2 * nd + 1], da, b[2], b[3]);
        load_b_cols(b, wg, LD, qc * 16, nd * 16, lane);
        mma_bf16(dva[2 * nd], pa, b[0], b[1]);
        mma_bf16(dva[2 * nd + 1], pa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* dst = dqkv + static_cast<long long>(stok[ri[r]]) * C3 + head * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < NTD; ++n) {
        *reinterpret_cast<float2*>(dst + p.C + n * 8) =
            make_float2(dka[n][2 * r] * p.scale, dka[n][2 * r + 1] * p.scale);
        *reinterpret_cast<float2*>(dst + 2 * p.C + n * 8) =
            make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels 2 and 3: d(ve)
// ---------------------------------------------------------------------------

// split blockIdx.z's partial of d(ve)[head, pix, s, c] = sum over windows w
// and candidates n of mass[w, head, (pix, n), s] * g[token (w, pix, n), head, c]
template <typename T, int HD>
__global__ void __launch_bounds__(kDveThreads)
window_dve_partial_kernel(const T* __restrict__ gout, const float* __restrict__ mass,
                          float* __restrict__ partial, WindowBwdParams p) {
  constexpr int MAXO = (64 * HD + kDveThreads - 1) / kDveThreads;  // P <= 64
  __shared__ float sm[kDveItems][65];
  __shared__ float sgr[kDveItems][HD + 1];
  const int pix = blockIdx.x, head = blockIdx.y, split = blockIdx.z;
  const int P = p.wh * p.ww;
  const int Tw = P * p.N;
  const int nwh = p.Hp / p.wh, nww = p.Wp / p.ww;
  const int items = p.nwin * p.N;
  const int per = (items + p.nsplit - 1) / p.nsplit;
  const int first = split * per, last = min(items, first + per);
  float acc[MAXO];
#pragma unroll
  for (int k = 0; k < MAXO; ++k) acc[k] = 0.f;
  for (int it0 = first; it0 < last; it0 += kDveItems) {
    const int nit = min(kDveItems, last - it0);
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
  float* out = partial + ((static_cast<long long>(split) * p.heads + head) * P + pix) * P * HD;
#pragma unroll
  for (int k = 0; k < MAXO; ++k) {
    const int o = k * kDveThreads + threadIdx.x;
    if (o < P * HD) out[o] = acc[k];
  }
}

// d(ve)[e] = sum of the nsplit partials of element e, in split order
__global__ void __launch_bounds__(kDveThreads)
window_dve_sum_kernel(const float* __restrict__ partial, float* __restrict__ dve, int n,
                      int nsplit) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) a += partial[static_cast<long long>(s) * n + e];
    dve[e] = a;
  }
}

template <int HD, int MT>
int launch_mma(const void* qkv, const float* table, const void* g, float* dqkv, float* dqr,
               float* dkr, float* mass, WindowBwdParams p, int nshift, size_t smem,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(window_bwd_mma_kernel<HD, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nwin + p.wpb - 1) / p.wpb, p.heads);
  window_bwd_mma_kernel<HD, MT><<<grid, p.wpb * MT * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), table, static_cast<const bf16*>(g), dqkv, dqr, dkr, mass,
      p, nshift);
  return static_cast<int>(cudaGetLastError());
}

constexpr size_t kMaxBlockSmem = 232448;  // 227 KB, the most a block may have

template <typename T, int HD>
int launch_bwd(const void* qkv, const float* table, const void* g, float* dqkv, float* dqr,
               float* dkr, float* mass, float* dve, float* partial, WindowBwdParams p,
               cudaStream_t stream) {
  const int P = p.wh * p.ww;
  const int Tw = P * p.N;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  int err = -1;  // -1: kernel 1 not launched yet
  if constexpr (sizeof(T) == 2) {
    const int nshift = p.N == 1 ? 0 : p.N == 2 ? 1 : p.N == 4 ? 2 : p.N == 8 ? 3 : -1;
    const int mt = Tw % 16 == 0 ? Tw / 16 : 0;
    size_t a, b, c;
    const size_t smem = wmma_smem<HD>(p.wpb * Tw, P, Tw, p.wpb, trows, &a, &b, &c);
    if (nshift >= 0 && smem <= kMaxBlockSmem) {
      if (mt == 1) err = launch_mma<HD, 1>(qkv, table, g, dqkv, dqr, dkr, mass, p, nshift, smem, stream);
      if (mt == 9) err = launch_mma<HD, 9>(qkv, table, g, dqkv, dqr, dkr, mass, p, nshift, smem, stream);
    }
  }
  if (err == -1) {
    const size_t smem = window_bwd_smem_bytes<T, HD>(p.wpb * Tw, P, Tw, trows);
    cudaError_t e = cudaFuncSetAttribute(window_attention_bwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((p.nwin + p.wpb - 1) / p.wpb, p.heads);
    window_attention_bwd_kernel<T, HD><<<grid, kBwdWarps * 32, smem, stream>>>(
        static_cast<const T*>(qkv), table, static_cast<const T*>(g), dqkv, dqr, dkr, mass, p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0) return err;
  window_dve_partial_kernel<T, HD><<<dim3(P, p.heads, p.nsplit), kDveThreads, 0, stream>>>(
      static_cast<const T*>(g), mass, partial, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = p.heads * P * P * HD;
  window_dve_sum_kernel<<<(n + kDveThreads - 1) / kDveThreads, kDveThreads, 0, stream>>>(
      partial, dve, n, p.nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(int hd, const void* qkv, const float* table, const void* g, float* dqkv,
                 float* dqr, float* dkr, float* mass, float* dve, float* partial,
                 WindowBwdParams p, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(qkv, table, g, dqkv, dqr, dkr, mass, dve, partial, p, s);
    case 32: return launch_bwd<T, 32>(qkv, table, g, dqkv, dqr, dkr, mass, dve, partial, p, s);
    case 64: return launch_bwd<T, 64>(qkv, table, g, dqkv, dqr, dkr, mass, dve, partial, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nmrf

extern "C" int nmrf_window_attention_bwd(const void* qkv, const void* table, const void* g,
                                         void* dqkv, void* dqr, void* dkr, void* mass,
                                         void* dve, void* dve_partial, int dtype, int B, int Hp,
                                         int Wp, int N, int C, int heads, int wh, int ww,
                                         int shift, int candidate_mask, int row0, int hp_total,
                                         int nsplit, float scale, void* stream) {
  using namespace nmrf;
  WindowBwdParams p;
  p.B = B; p.Hp = Hp; p.Wp = Wp; p.N = N; p.C = C; p.heads = heads;
  p.wh = wh; p.ww = ww; p.shift = shift;
  p.candidate_mask = candidate_mask; p.scale = scale;
  p.row0 = row0; p.hp_total = hp_total; p.nsplit = nsplit;
  const int Tw = wh * ww * N;
  if (wh * ww > 64 || nsplit < 1) return static_cast<int>(cudaErrorInvalidValue);  // P <= 64
  p.wpb = Tw >= 128 ? 1 : 128 / Tw;
  p.nwin = B * (Hp / wh) * (Wp / ww);
  const float* tbl = static_cast<const float*>(table);
  float* out[6] = {static_cast<float*>(dqkv), static_cast<float*>(dqr),
                   static_cast<float*>(dkr),  static_cast<float*>(mass),
                   static_cast<float*>(dve),  static_cast<float*>(dve_partial)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_bwd<float>(C / heads, qkv, tbl, g, out[0], out[1], out[2], out[3], out[4],
                               out[5], p, s);
  if (dtype == kBF16)
    return dispatch_bwd<__nv_bfloat16>(C / heads, qkv, tbl, g, out[0], out[1], out[2], out[3],
                                       out[4], out[5], p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
