// Fully fused backward of the shifted-window NMP attention (B7).
//
// Replaces nmrf_tpu/ops/pallas/attention.py:_wan_bwd_fused_pos_kernel,
// driven by window_attention_pos_bwd / window_attention_pos_op (the JAX
// package's NMRF_FUSED_POS=1 training path).
//
// Function: K1b's (window_attention_bwd.cu), with the positional backward
// moved into the kernel.  Per window and head, with dS, P, dqr, dkr and
// mass as there, and ke/qe/ve[p,s] the k/q/v columns of table row
// rel(p,s) in the (head, component, hd) column order:
//   dq_i = scale (sum_j dS_ij k_j + sum_s dqr[i,s] ke[pix(i),s])
//   dk_j = scale (sum_i dS_ij q_i + sum_p dkr[j,p] qe[p,pix(j)])
//   dv_j = sum_i P_ij g_i
// and d(table) at row rel(p,s), summed over every window and sample:
//   q columns  scale sum_{j: pix(j)=s} dkr[j,p] k_j
//   k columns  scale sum_{i: pix(i)=p} dqr[i,s] q_i
//   v columns        sum_{i: pix(i)=p} mass[i,s] g_i
// dqr, dkr and mass stay in shared memory: nothing of [G, h, T, P] size
// reaches device memory.  d(qkv) is written in the input's dtype, d(table)
// in f32.  The shifted-region mask takes global rows (row0, hp_total) as
// in K1 and K1b.
//
// Design.  Kernel 1, a fixed grid of nblk x heads blocks of 8 warps (nblk
// comes from the wrapper, a function of the shapes only).  Block b walks
// the window groups b, b + nblk, ... (the grouping of K1b: one window at
// T >= 128, else floor(128 / T) windows).  Per group:
//   1. q, k, v and g rows to shared memory in the input's dtype; the
//      head's qe|ke|ve table columns are staged and the pixel-granular qr,
//      kr and gve blocks [rows, P] computed from them, as in K1b; the
//      shifted-region id of each row's token too (and, once, the pixel of
//      each token), so the two passes' masks cost two shared loads and no
//      integer division.
//   2. Row pass (a warp per query row, as K1b): softmax, dP, dS; dqr and
//      mass of the row into shared memory; then dq with its positional
//      half from the staged ke rows, walked by row offsets (no division).
//   3. Column pass (a warp per key row, as K1b): dk with its positional
//      half, dv, and dkr of the row into shared memory.
//   4. Table pass: each element (rel row, column) of the head's table
//      cotangent has one owning thread, which sums the group's terms in a
//      fixed loop (windows, pixel pairs of that rel row, candidates) and
//      adds them into the block's own f32 partial in device memory (the
//      partial's load is issued before the sum, to overlap its latency).
// The staged table stays in shared memory for the whole launch (staged
// once) where it fits, as at the training path's bf16 shapes; otherwise
// (f32 at Inference) it is staged per group into the space that then
// holds dqr | dkr | mass, and the positional halves read the ke/qe rows
// from device memory (the f32 table is 186 KB and stays in L2).
// Kernel 2 sums the nblk partials of each element in block order.  No
// float atomics anywhere, in shared or device memory: distinct (p,s)
// pairs share a rel row, and an atomic sum would change its order from
// run to run.  The result is deterministic: two launches on the same
// inputs give the same bits.  A partial per window would be 190 MB at
// Inference (1024 windows x 4 heads x 46 KB); nblk = 66 per head there
// makes 12 MB.  This also folds in K1b's d(ve) reduction kernel, whose
// grid of P x heads blocks left most SMs idle, and its f32 mass buffer.
// Shared memory at Inference (T 144, P 36, hd 32): 222 KB in bf16 with the
// table kept, 212 KB in f32 without, one block per SM; at hd 64 the
// Inference window does not fit in the 227 KB a block may have and the
// launch is refused (the wrapper raises), as K1b's is.
//
// Bound on the H100 (bf16, training shape 48x96, batch 8, Inference): the
// launch must read qkv, g and the table and write d(qkv) and d(table) once
// (about 0.26 GB), and do K1b's matrix work (the five T x T and eight
// T x P products, about 38 GFLOP): the bytes bound it, at about 0.08 ms.
// Like K1b this version does its products on CUDA cores from shared memory
// and recomputes the logits in the column pass, so it is issue-bound far
// above that; mma/wgmma tiles are the redesign's tool.

#include "common.cuh"

namespace nmrf {

struct PosBwdParams {
  int B, Hp, Wp, N, C, heads, wh, ww, shift, candidate_mask, wpb, nwin, ngroups, nblk;
  int keep_table;  // the staged table stays in shared memory for the launch
  int row0, hp_total;  // global row of local row 0; global padded height
  float scale;
};

constexpr int kPosWarps = 8;
constexpr int kSumThreads = 256;

__device__ __forceinline__ int pos_rel_row(int p, int s, int wh, int ww) {
  const int py = p / ww, px = p % ww, sy = s / ww, sx = s % ww;
  return (py - sy + wh - 1) * (2 * ww - 1) + (px - sx + ww - 1);
}

// row stride of the staged rows: an odd number of 32-bit words
template <typename T, int HD>
__host__ __device__ constexpr int pos_row_stride() { return sizeof(T) == 4 ? HD + 1 : HD + 2; }

// floats of the region that holds dqr|dkr|mass and the staged table: side
// by side when the table is kept, else the table first, then dqr|dkr|mass
__host__ __device__ inline size_t pos_region_floats(int rows, int P, int trows, int TS,
                                                    int keep_table) {
  const size_t a = static_cast<size_t>(3) * rows * P, b = static_cast<size_t>(trows) * TS;
  return keep_table ? a + b : (a > b ? a : b);
}

template <typename T, int HD>
inline size_t pos_bwd_smem_bytes(int rows, int P, int Tw, int trows, int keep_table) {
  const size_t tok = static_cast<size_t>(4) * rows * pos_row_stride<T, HD>() * sizeof(T);
  const size_t tok_aligned = (tok + 15) / 16 * 16;
  const size_t pos = (static_cast<size_t>(3) * rows * P + 2 * rows) * sizeof(float);
  const size_t region = pos_region_floats(rows, P, trows, 3 * HD + 1, keep_table) * sizeof(float);
  const size_t scratch = static_cast<size_t>(kPosWarps) * 2 * Tw * sizeof(float);
  const size_t meta = static_cast<size_t>(Tw + rows) * sizeof(int);
  return tok_aligned + pos + region + scratch + meta;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kPosWarps * 32)
window_pos_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ table,
                      const T* __restrict__ gout, T* __restrict__ dqkv,
                      float* __restrict__ partial, PosBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = pos_row_stride<T, HD>();
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
  float* region = sD + rows;
  float* sdqr = region;                 // [rows, P]
  float* sdkr = sdqr + rows * P;        // [rows, P]
  float* smass = sdkr + rows * P;       // [rows, P]
  // the staged table [trows, TS]: after dqr|dkr|mass when kept, else over them
  float* stbl = p.keep_table ? smass + rows * P : region;
  float* scratch = region + pos_region_floats(rows, P, trows, TS, p.keep_table);
  int* spix = reinterpret_cast<int*>(scratch + kPosWarps * 2 * Tw);  // [Tw] pixel of token
  int* sreg = spix + Tw;  // [rows] shifted-region id of each row's token (0 unshifted)

  const int head = blockIdx.y;
  const int nwh = p.Hp / p.wh, nww = p.Wp / p.ww;
  const int tcol = head * 3 * HD;
  // rows of the positional halves' table: the kept copy, else device memory
  const float* ptab = p.keep_table ? stbl : table + tcol;
  const int pstride = p.keep_table ? TS : C3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* prow = scratch + warp * 2 * Tw;  // probabilities of one row/column
  float* drow = prow + Tw;                // dS of one row/column

  // this block's partial of the head's table cotangent: [trows, 3 HD] at
  // the head's columns of a [trows, C3] slab; each element has one owner
  float* part = partial + static_cast<long long>(blockIdx.x) * trows * C3 + tcol;
  const int nacc = trows * 3 * HD;
  for (int o = threadIdx.x; o < nacc; o += blockDim.x) part[(o / (3 * HD)) * C3 + o % (3 * HD)] = 0.f;

  auto stage_table = [&]() {
    for (int idx = threadIdx.x; idx < trows * 3 * HD; idx += blockDim.x) {
      const int t = idx / (3 * HD), c = idx % (3 * HD);
      stbl[t * TS + c] = __ldg(table + static_cast<long long>(t) * C3 + tcol + c);
    }
  };
  // once; the group loop's first barrier orders them
  if (p.keep_table) stage_table();
  for (int t = threadIdx.x; t < Tw; t += blockDim.x) spix[t] = t / p.N;
  const int W2 = 2 * p.ww - 1;  // table rows per relative row offset

  auto region_of = [&](int win, int t) {
    const int rem = win % (nwh * nww);
    const int y = p.row0 + (rem / nww) * p.wh + (t / p.N) / p.ww;  // global row
    const int x = (rem % nww) * p.ww + (t / p.N) % p.ww;
    const int ry = (y >= p.hp_total - p.wh) + (y >= p.hp_total - p.shift);
    const int rx = (x >= p.Wp - p.ww) + (x >= p.Wp - p.shift);
    return 3 * ry + rx;
  };
  // the additive mask of tokens (ti, tj) of pixels (pi, pj) of the window
  // whose rows start at base: other candidates of a pixel, other regions
  auto masked = [&](int base, int ti, int tj, int pi, int pj) {
    return (p.candidate_mask && pi == pj && ti != tj) ||
           (p.shift > 0 && sreg[base + ti] != sreg[base + tj]);
  };

  for (int grp = blockIdx.x; grp < p.ngroups; grp += p.nblk) {
    const int win0 = grp * p.wpb;
    const int nvalid = min(p.wpb, p.nwin - win0);
    auto token_of = [&](int r) -> long long {
      if (r / Tw >= nvalid) return -1;
      const int win = win0 + r / Tw;
      const int t = r % Tw;
      const int b = win / (nwh * nww), rem = win % (nwh * nww);
      const int y = (rem / nww) * p.wh + (t / p.N) / p.ww;
      const int x = (rem % nww) * p.ww + (t / p.N) % p.ww;
      return ((static_cast<long long>(b) * p.Hp + y) * p.Wp + x) * p.N + t % p.N;
    };

    // ---- 1. staging and the positional blocks ----
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
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      sreg[r] = p.shift > 0 && r / Tw < nvalid ? region_of(win0 + r / Tw, r % Tw) : 0;
    if (!p.keep_table) stage_table();
    __syncthreads();
    // qr and kr with the scale folded in, gve[r, s] = g_r . ve[rel(pix(r), s)]
    for (int idx = threadIdx.x; idx < rows * P; idx += blockDim.x) {
      const int r = idx / P, s = idx % P;
      const int pix = (r % Tw) / p.N;
      const float* qe = stbl + pos_rel_row(s, pix, p.wh, p.ww) * TS;
      const float* kve = stbl + pos_rel_row(pix, s, p.wh, p.ww) * TS;
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
    __syncthreads();  // unless kept, the staged table is dead: dqr | dkr | mass

    // ---- 2. row pass: softmax, dP, dS, dqr, mass, dq, lse, D ----
    for (int r = warp; r < rows; r += kPosWarps) {
      const long long tok = token_of(r);
      if (tok < 0) break;  // rows past the valid windows are all at the end
      const int base = (r / Tw) * Tw;
      const int ti = r % Tw;
      const int pix_i = spix[ti];
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
        const int pj = spix[j];
        s = s * p.scale + sqr[r * P + pj] + skr[(base + j) * P + pix_i];
        if (masked(base, ti, j, pix_i, pj)) s += kNegInf;
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
        dp += sgve[r * P + spix[j]];
        const float pr = prow[j] * inv;
        prow[j] = pr;
        drow[j] = dp;
        dsum += pr * dp;
      }
      const float D = warp_sum(dsum);
      for (int j = lane; j < Tw; j += 32) drow[j] = prow[j] * (drow[j] - D);
      __syncwarp();
      for (int s = lane; s < P; s += 32) {  // lanes own key pixels
        float ds = 0.f, m = 0.f;
        for (int n = 0; n < p.N; ++n) {
          ds += drow[s * p.N + n];
          m += prow[s * p.N + n];
        }
        sdqr[r * P + s] = ds;
        smass[r * P + s] = m;
      }
      if (lane == 0) {
        slse[r] = mx + logf(sum);
        sD[r] = D;
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < NC; ++k) {  // lanes own channels
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
          // positional half: sum_s dqr[i, s] ke[pix(i), s], with
          // rel(pix(i), s) = rel(pix(i), 0) - sy (2 ww - 1) - sx
          const int py = pix_i / p.ww, px = pix_i - py * p.ww;
          const float* ke0 = ptab + HD + c + ((py + p.wh - 1) * W2 + px + p.ww - 1) * pstride;
          const float* dqr_r = sdqr + r * P;
          float ap = 0.f;
          for (int sy = 0; sy < p.wh; ++sy) {
            const float* kerow = ke0 - sy * W2 * pstride;
            for (int sx = 0; sx < p.ww; ++sx) ap += dqr_r[sy * p.ww + sx] * kerow[-sx * pstride];
          }
          dqkv[tok * C3 + head * HD + c] = from_float<T>((a0 + a1 + ap) * p.scale);
        }
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- 3. column pass: dk, dv, dkr of key row r ----
    for (int r = warp; r < rows; r += kPosWarps) {
      const long long tok = token_of(r);
      if (tok < 0) break;
      const int base = (r / Tw) * Tw;
      const int tj = r % Tw;
      const int pix_j = spix[tj];
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
        const int pi = spix[i];
        s = s * p.scale + sqr[ri * P + pix_j] + skr[r * P + pi];
        if (masked(base, i, tj, pi, pix_j)) s += kNegInf;
        const float pr = expf(s - slse[ri]);
        dp += sgve[ri * P + pix_j];
        prow[i] = pr;
        drow[i] = pr * (dp - sD[ri]);
      }
      __syncwarp();
      for (int q = lane; q < P; q += 32) {  // lanes own query pixels
        float ds = 0.f;
        for (int n = 0; n < p.N; ++n) ds += drow[q * p.N + n];
        sdkr[r * P + q] = ds;
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
          // positional half: sum_p dkr[j, p] qe[p, pix(j)], with
          // rel(p, pix(j)) = rel(0, pix(j)) + py (2 ww - 1) + px
          const int py = pix_j / p.ww, px = pix_j - py * p.ww;
          const float* qe0 = ptab + c + ((p.wh - 1 - py) * W2 + p.ww - 1 - px) * pstride;
          const float* dkr_r = sdkr + r * P;
          float ap = 0.f;
          for (int qy = 0; qy < p.wh; ++qy) {
            const float* qerow = qe0 + qy * W2 * pstride;
            for (int qx = 0; qx < p.ww; ++qx) ap += dkr_r[qy * p.ww + qx] * qerow[qx * pstride];
          }
          dqkv[tok * C3 + p.C + head * HD + c] = from_float<T>((dk + ap) * p.scale);
          dqkv[tok * C3 + 2 * p.C + head * HD + c] = from_float<T>(dv);
        }
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- 4. table pass: the group's terms into this block's partial ----
    // element o = (rel row t, component, channel c); the (p, s) pairs with
    // rel(p, s) = t are those with p - s = (dy, dx)
    for (int o = threadIdx.x; o < nacc; o += blockDim.x) {
      const int t = o / (3 * HD), j = o % (3 * HD);
      const int comp = j / HD, c = j % HD;
      const int dy = t / W2 - (p.wh - 1);
      const int dx = t % W2 - (p.ww - 1);
      const int py0 = max(0, dy), py1 = min(p.wh, p.wh + dy);
      const int px0 = max(0, dx), px1 = min(p.ww, p.ww + dx);
      float* dst = part + t * C3 + j;
      const float prev = *dst;
      float a = 0.f;
      for (int w = 0; w < nvalid; ++w) {
        const int base = w * Tw;
        for (int py = py0; py < py1; ++py) {
          for (int px = px0; px < px1; ++px) {
            const int pp = py * p.ww + px, ss = (py - dy) * p.ww + (px - dx);
            if (comp == 0) {  // q columns: dkr[j, p] k_j over key tokens j of pixel s
              for (int n = 0; n < p.N; ++n) {
                const int r = base + ss * p.N + n;
                a += sdkr[r * P + pp] * to_float(sk[r * RS + c]);
              }
            } else if (comp == 1) {  // k columns: dqr[i, s] q_i over query tokens i of pixel p
              for (int n = 0; n < p.N; ++n) {
                const int r = base + pp * p.N + n;
                a += sdqr[r * P + ss] * to_float(sq[r * RS + c]);
              }
            } else {  // v columns: mass[i, s] g_i over query tokens i of pixel p
              for (int n = 0; n < p.N; ++n) {
                const int r = base + pp * p.N + n;
                a += smass[r * P + ss] * to_float(sg[r * RS + c]);
              }
            }
          }
        }
      }
      *dst = prev + (comp < 2 ? a * p.scale : a);
    }
    __syncthreads();  // the next group overwrites the staged rows
  }
}

// d(table)[o] = sum over the nblk partials, in block order
__global__ void __launch_bounds__(kSumThreads)
window_pos_bwd_sum_kernel(const float* __restrict__ partial, float* __restrict__ dtable, int nblk,
                          int n) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float a = 0.f;
  for (int b = 0; b < nblk; ++b) a += partial[static_cast<long long>(b) * n + o];
  dtable[o] = a;
}

template <typename T, int HD>
int launch_pos_bwd(const void* qkv, const float* table, const void* g, void* dqkv, float* partial,
                   float* dtable, PosBwdParams p, cudaStream_t stream) {
  const int P = p.wh * p.ww;
  const int Tw = P * p.N;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.keep_table = pos_bwd_smem_bytes<T, HD>(p.wpb * Tw, P, Tw, trows, 1) <=
                 static_cast<size_t>(max_smem);
  const size_t smem = pos_bwd_smem_bytes<T, HD>(p.wpb * Tw, P, Tw, trows, p.keep_table);
  err = cudaFuncSetAttribute(window_pos_bwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_pos_bwd_kernel<T, HD><<<dim3(p.nblk, p.heads), kPosWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), table, static_cast<const T*>(g), static_cast<T*>(dqkv),
      partial, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = trows * 3 * p.C;
  window_pos_bwd_sum_kernel<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
      partial, dtable, p.nblk, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_pos_bwd(int hd, const void* qkv, const float* table, const void* g, void* dqkv,
                     float* partial, float* dtable, PosBwdParams p, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_pos_bwd<T, 16>(qkv, table, g, dqkv, partial, dtable, p, s);
    case 32: return launch_pos_bwd<T, 32>(qkv, table, g, dqkv, partial, dtable, p, s);
    case 64: return launch_pos_bwd<T, 64>(qkv, table, g, dqkv, partial, dtable, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nmrf

// partial: nblk x [(2wh-1)(2ww-1), 3C] f32 scratch; dtable: [(2wh-1)(2ww-1), 3C] f32
extern "C" int nmrf_window_attention_pos_bwd(const void* qkv, const void* table, const void* g,
                                             void* dqkv, void* partial, void* dtable, int dtype,
                                             int B, int Hp, int Wp, int N, int C, int heads,
                                             int wh, int ww, int shift, int candidate_mask,
                                             int row0, int hp_total, int nblk, float scale,
                                             void* stream) {
  using namespace nmrf;
  if (wh * ww > 64 || nblk < 1) return static_cast<int>(cudaErrorInvalidValue);  // P <= 64
  PosBwdParams p;
  p.B = B; p.Hp = Hp; p.Wp = Wp; p.N = N; p.C = C; p.heads = heads;
  p.wh = wh; p.ww = ww; p.shift = shift;
  p.candidate_mask = candidate_mask; p.scale = scale;
  p.row0 = row0; p.hp_total = hp_total;
  const int Tw = wh * ww * N;
  p.wpb = Tw >= 128 ? 1 : 128 / Tw;
  p.nwin = B * (Hp / wh) * (Wp / ww);
  p.ngroups = (p.nwin + p.wpb - 1) / p.wpb;
  p.nblk = nblk;
  const float* tbl = static_cast<const float*>(table);
  float* part = static_cast<float*>(partial);
  float* dt = static_cast<float*>(dtable);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_pos_bwd<float>(C / heads, qkv, tbl, g, dqkv, part, dt, p, s);
  if (dtype == kBF16)
    return dispatch_pos_bwd<__nv_bfloat16>(C / heads, qkv, tbl, g, dqkv, part, dt, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
