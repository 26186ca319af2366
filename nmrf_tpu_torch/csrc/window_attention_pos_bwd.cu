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
// The grid and the sums, in both versions below.  Kernel 1 runs on a fixed
// grid of nblk x heads blocks (nblk comes from the wrapper, a function of
// the shapes only); block b walks the window groups b, b + nblk, ... (the
// grouping of K1b: one window at T >= 128, else floor(128 / T) windows) and
// adds each group's table terms into its own f32 partial of d(table) in
// device memory, every element with one owner, in group order.  Kernel 2
// sums the nblk partials of each element in block order.  No float atomics
// anywhere, in shared or device memory: distinct (p,s) pairs share a rel
// row, and an atomic sum would change its order from run to run.  Two
// launches on the same inputs give the same bits.  A partial per window
// would be 190 MB at Inference (1024 windows x 4 heads x 46 KB); nblk = 66
// per head there makes 12 MB.  d(qkv) rows have one writer each.
//
// bf16 (the training step's launches: T = 144 at Inference, 6x6x4, and
// T = 16 at Refinement, 4x4x1; any N in {1, 2, 4, 8} with T = 16 or 144):
// the tensor-core kernel, mma.sync.m16n8k16 with bf16 operands and f32
// accumulation fed by ldmatrix, one warp per 16 rows of a group (9 warps
// at Inference, 8 windows of one warp at Refinement), K1b's row and column
// passes with the positional backward added as five dense products.  With
// trows = (2wh-1)(2ww-1) table rows (121 at Inference, padded to 128) and
//   Wq[i, t] = dqr[i, s] where rel(pix(i), s) = t,
//   Wk[j, t] = dkr[j, p] where rel(p, pix(j)) = t,
//   Wm[i, t] = mass[i, s] where rel(pix(i), s) = t
// ([T, trows], zero where no pixel of the window matches; for a fixed pixel
// s -> rel is injective, so an entry has at most one source), the sums
// above are dq_pos = Wq KE, dk_pos = Wk QE, d(table)[q] = scale Wk^T K,
// d(table)[k] = scale Wq^T Q and d(table)[v] = Wm^T G, KE, QE the head's
// staged table columns.  The A fragments are gathered from the f32 blocks
// through that index (w_col) and packed to bf16, as the JAX kernel's
// operands are when not exact; the table products take W as bf16 hi + lo
// parts, since d(table) sums over every window of the batch.  Per group:
//   1. the token and shifted region of each row; q, k, v and g rows to
//      shared memory with 16-byte cp.async, rows padded to HD + 8 (no
//      ldmatrix bank conflict);
//   2. qr, kr and gve [rows, P] (f32): Q, K and G against every row of the
//      staged table on the tensor cores, scattered to their pixels;
//   3. row pass, three sweeps over 16-key chunks (max and sum; P and D;
//      P again, dS, dq += dS K), P and dS kept in shared memory as bf16.
//      In sweep 3 dqr, mass and dkr of a chunk overwrite the qr, gve and
//      kr entries the chunk has just read (a __syncwarp between): a
//      pixel's N rows lie in one warp's 16-row tile (N divides 16), so
//      column s of qr[i, .] and gve[i, .] and column pix(i) of kr[j, .] are
//      read and written only by the warp that owns row i.  Then dq += Wq KE;
//   4. column pass, a warp per 16 key rows: dk = dS^T Q + Wk QE and
//      dv = P^T G, dS and P by ldmatrix.trans, no logit recomputed;
//   5. the table: units of (16 table rows, component) owned by one warp
//      each accumulate their product over the group's rows and add it to
//      the partial, which they read once and store once per group.
// The staged table (bf16, [128, 3 HD + 8] at Inference) stays in shared
// memory for the launch.  Shared memory at Inference (hd 32): 46,080 B of
// rows, 62,208 of qr|kr|gve (then dqr|dkr|mass), 87,552 of P and dS, 26,624
// of table, 1,152 of ids: 223,616 of the 232,448 a block may have, one
// block per SM; 92,160 at Refinement.  Softmax, lse, D, dqr, dkr and mass
// stay in f32; P and dS are rounded to bf16 only as mma operands.
//
// f32 (the phase 3 and 4 checks at 1e-4, which TF32 would not meet) and
// other shapes: the CUDA-core kernel, 8 warps.  Per group:
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
// once) where it fits; otherwise (f32 at Inference) it is staged per group
// into the space that then holds dqr | dkr | mass, and the positional
// halves read the ke/qe rows from device memory (the f32 table is 186 KB
// and stays in L2).  Shared memory at Inference (T 144, P 36, hd 32):
// 212 KB in f32 without the table, one block per SM.  At hd 64 the
// Inference window fits neither version in the 227 KB a block may have and
// the launch is refused (the wrapper raises), as K1b's is.
//
// Bound on the H100 (bf16, training shape 48x96, batch 8, Inference): the
// launch must read qkv, g and the table and write d(qkv) and d(table) once
// (about 0.26 GB), and do K1b's matrix work (the five T x T and eight
// T x P products, about 38 GFLOP): the bytes bound it, at about 0.08 ms.
// The tensor-core kernel does the T x P work as T x trows products (3.4x
// the operations, on the tensor cores) and keeps every intermediate in
// shared memory.  It stays far above the bound (PERF.md); what holds it
// there is not measured (ncu does not run on the card's machine): the
// candidate is one 223 KB block per SM walking its window groups one
// after another, so a group's row loads, sweeps and table products do not
// overlap.

#include "common.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kPosMmaMaxWarps = 9;  // one warp per 16 rows of a window group

__host__ __device__ constexpr size_t pos_align16(size_t x) { return (x + 15) / 16 * 16; }

// byte offsets of the bf16 kernel's shared memory: q|k|v|g rows [rows,
// HD + 8], the f32 blocks qr|kr|gve [rows, P] (later dqr|dkr|mass, in
// place), P|dS of every window [T, T + 8], the staged table [TR, 3 HD + 8]
// (kept for the launch), then the token and region ids; returns the total
template <int HD>
__host__ __device__ inline size_t pos_mma_smem(int rows, int P, int T, int wpb, int TR,
                                               size_t* pos_off, size_t* pds_off,
                                               size_t* tbl_off, size_t* int_off) {
  *pos_off = static_cast<size_t>(4) * rows * (HD + 8) * sizeof(bf16);
  *pds_off = *pos_off + pos_align16(static_cast<size_t>(3) * rows * P * sizeof(float));
  *tbl_off = *pds_off + pos_align16(static_cast<size_t>(2) * wpb * T * (T + 8) * sizeof(bf16));
  *int_off = *tbl_off + static_cast<size_t>(TR) * (3 * HD + 8) * sizeof(bf16);
  return *int_off + static_cast<size_t>(2) * rows * sizeof(int);
}

// The column of a pixel-granular block row that table row t = (dy, dx)
// meets, for the row's pixel (y, x): s with rel((y, x), s) = t (qr, gve, dqr,
// mass: the Wq and Wm matrices), or with key, p with rel(p, (y, x)) = t (kr,
// dkr: Wk); -1 where no pixel of the window matches.
__device__ __forceinline__ int w_col(int y, int x, int dy, int dx, int wh, int ww, bool key) {
  const int sy = key ? y - (wh - 1) + dy : y + (wh - 1) - dy;
  const int sx = key ? x - (ww - 1) + dx : x + (ww - 1) - dx;
  return sy >= 0 && sy < wh && sx >= 0 && sx < ww ? sy * ww + sx : -1;
}

// MT 16-row tiles per window (T = 16 MT); N = 1 << nshift candidates
template <int HD, int MT>
__global__ void __launch_bounds__(kPosMmaMaxWarps * 32)
window_pos_bwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ table,
                          const bf16* __restrict__ gout, bf16* __restrict__ dqkv,
                          float* __restrict__ partial, PosBwdParams p, int nshift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int T = 16 * MT, LD = HD + 8, KS = HD / 16, NTD = HD / 8;
  constexpr int TS = 3 * HD + 8;  // staged table row (qe | ke | ve)
  constexpr int PL = T + 8;       // kept P / dS row
  constexpr int CH = HD / 8;      // 16-byte chunks of a row
  const int P = p.wh * p.ww;
  const int rows = p.wpb * T;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  const int TR = (trows + 15) / 16 * 16;
  const int W2 = 2 * p.ww - 1;
  const int C3 = 3 * p.C;
  size_t pos_off, pds_off, tbl_off, int_off;
  pos_mma_smem<HD>(rows, P, T, p.wpb, TR, &pos_off, &pds_off, &tbl_off, &int_off);
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [rows, LD] each
  bf16* sk = sq + rows * LD;
  bf16* sv = sk + rows * LD;
  bf16* sg = sv + rows * LD;
  float* sqr = reinterpret_cast<float*>(smem_raw + pos_off);  // qr, then dqr [rows, P]
  float* skr = sqr + rows * P;                                // kr, then dkr
  float* sgve = skr + rows * P;                               // gve, then mass
  bf16* stbl = reinterpret_cast<bf16*>(smem_raw + tbl_off);  // [TR, TS]
  int* stok = reinterpret_cast<int*>(smem_raw + int_off);    // token of each row, -1 past nwin
  int* sreg = stok + rows;                                   // shifted region of each row

  const int head = blockIdx.y;
  const int nwh = p.Hp / p.wh, nww = p.Wp / p.ww;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  // this block's partial of the head's table cotangent: [trows, 3 HD] at
  // the head's columns of a [trows, C3] slab
  float* part = partial + static_cast<long long>(blockIdx.x) * trows * C3 + head * 3 * HD;
  if (blockIdx.x >= p.ngroups) {  // no window group: a zero partial
    for (int o = threadIdx.x; o < trows * 3 * HD; o += blockDim.x)
      part[(o / (3 * HD)) * C3 + o % (3 * HD)] = 0.f;
    return;
  }

  // the head's qe | ke | ve table columns as bf16 (the table holds bf16
  // values, so exactly), once; the first group's barriers order them
  for (int idx = threadIdx.x; idx < TR * 3 * HD; idx += blockDim.x) {
    const int t = idx / (3 * HD), c = idx % (3 * HD);
    const float x = t < trows ? __ldg(table + static_cast<long long>(t) * C3 + head * 3 * HD + c)
                              : 0.f;
    stbl[t * TS + c] = __float2bfloat16(x);
  }

  // this warp: rows r0w.. of window wi of a group, its row tile rt
  const int r0w = warp * 16, wi = warp / MT, rt = warp % MT;
  const int base = wi * T;  // group row of the window's token 0
  int ti[2], ri[2], pr[2], py[2], px[2];  // the thread's two rows: token, group row, pixel
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ti[r] = rt * 16 + gq + 8 * r;
    ri[r] = base + ti[r];
    pr[r] = ti[r] >> nshift;
    py[r] = pr[r] / p.ww;
    px[r] = pr[r] - py[r] * p.ww;
  }
  bf16* sP = reinterpret_cast<bf16*>(smem_raw + pds_off) + wi * 2 * T * PL;  // [T, PL]
  bf16* sdS = sP + T * PL;                                                    // [T, PL]
  const bf16* wq = sq + base * LD;
  const bf16* wk = sk + base * LD;
  const bf16* wv = sv + base * LD;
  const bf16* wg = sg + base * LD;
  const int ncol = 1 << nshift;  // tokens of a pixel

  for (int grp = blockIdx.x; grp < p.ngroups; grp += p.nblk) {
    const int win0 = grp * p.wpb;
    const int nvalid = min(p.wpb, p.nwin - win0);
    const bool wvalid = wi < nvalid;
    auto token_of = [&](int r) {
      const int win = win0 + r / T, t = r % T;
      if (win >= p.nwin) return -1;
      const int b = win / (nwh * nww), rem = win % (nwh * nww);
      const int y = (rem / nww) * p.wh + (t >> nshift) / p.ww;
      const int x = (rem % nww) * p.ww + (t >> nshift) % p.ww;
      return ((b * p.Hp + y) * p.Wp + x) * p.N + (t & (ncol - 1));
    };

    // ---- 1. token and region ids, the q|k|v|g rows ----
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int tok = token_of(r);
      int reg = 0;
      if (tok >= 0 && p.shift > 0) {
        const int win = win0 + r / T, t = (r % T) >> nshift;
        const int rem = win % (nwh * nww);
        const int gy = p.row0 + (rem / nww) * p.wh + t / p.ww;  // global row
        const int x = (rem % nww) * p.ww + t % p.ww;
        const int ry = (gy >= p.hp_total - p.wh) + (gy >= p.hp_total - p.shift);
        const int rx = (x >= p.Wp - p.ww) + (x >= p.Wp - p.shift);
        reg = 3 * ry + rx;
      }
      stok[r] = tok;
      sreg[r] = reg;
    }
    for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const int tok = token_of(r);
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

    // ---- 2. positional blocks: Q, K and G against every table row ----
    {
      uint32_t qa[KS][4], ka[KS][4], ga[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        load_a(qa[ks], sq, LD, r0w, ks * 16, lane);
        load_a(ka[ks], sk, LD, r0w, ks * 16, lane);
        load_a(ga[ks], sg, LD, r0w, ks * 16, lane);
      }
      for (int tp = 0; tp < TR / 16; ++tp) {
        float cq[2][4] = {}, ck[2][4] = {}, cg[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[4];
          load_b_rows(b, stbl + HD, TS, tp * 16, ks * 16, lane);  // ke columns
          mma_bf16(cq[0], qa[ks], b[0], b[1]);
          mma_bf16(cq[1], qa[ks], b[2], b[3]);
          load_b_rows(b, stbl, TS, tp * 16, ks * 16, lane);  // qe columns
          mma_bf16(ck[0], ka[ks], b[0], b[1]);
          mma_bf16(ck[1], ka[ks], b[2], b[3]);
          load_b_rows(b, stbl + 2 * HD, TS, tp * 16, ks * 16, lane);  // ve columns
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
            const int row = r0w + gq + 8 * r;
            int s = w_col(py[r], px[r], dy, dx, p.wh, p.ww, false);  // t = rel(pix, s)
            if (s >= 0) {
              sqr[row * P + s] = cq[nt][e] * p.scale;
              sgve[row * P + s] = cg[nt][e];
            }
            s = w_col(py[r], px[r], dy, dx, p.wh, p.ww, true);  // t = rel(s, pix)
            if (s >= 0) skr[row * P + s] = ck[nt][e] * p.scale;
          }
      }
    }
    __syncthreads();  // kr[j, .] is read by the warps of the query pixels

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
      // sum over the key tokens of each pixel (the quad's lanes), stored
      // at column pix of row ri[r] of dst
      auto pixel_sum = [&](float* dst, const float v[2][4], int c, int j0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (ncol == 1) {
            dst[ri[r] * P + j0] = v[c][2 * r];
            dst[ri[r] * P + j0 + 1] = v[c][2 * r + 1];
          } else {
            float a = v[c][2 * r] + v[c][2 * r + 1];
            for (int o = 1; o < ncol / 2; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
            if ((t4 & (ncol / 2 - 1)) == 0) dst[ri[r] * P + (j0 >> nshift)] = a;
          }
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
      // sweep 2: P (to shared memory as bf16), D = sum_j P dP
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
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<uint32_t*>(sP + ti[r] * PL + j0) =
                pack_bf16(s[c][2 * r], s[c][2 * r + 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) D[r] = quad_sum(D[r]);

      // sweep 3: P again, dS = P (dP - D) (to shared memory as bf16), dq;
      // dqr, mass and dkr of the chunk replace the qr, gve and kr entries
      // the chunk has just read, which no other warp reads (a pixel's rows
      // lie in one warp's tile)
      float dqa[NTD][4];
#pragma unroll
      for (int n = 0; n < NTD; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
      for (int kp = 0; kp < MT; ++kp) {
        float s[2][4], ds[2][4];
        logit_chunk(s, kp);
        dp_chunk(ds, kp);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[c][e] = __expf(s[c][e] - mx[e >> 1]) * inv[e >> 1];
            ds[c][e] = s[c][e] * (ds[c][e] - D[e >> 1]);
          }
        __syncwarp();  // every lane has read the chunk's qr, kr and gve
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j0 = kp * 16 + c * 8 + 2 * t4;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<uint32_t*>(sdS + ti[r] * PL + j0) =
                pack_bf16(ds[c][2 * r], ds[c][2 * r + 1]);
          pixel_sum(sqr, ds, c, j0);  // dqr
          pixel_sum(sgve, s, c, j0);  // mass
          // dkr: sums over the query tokens of the row's pixel (lanes gq ^ 1, 2, 4)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float a = ds[c][e];
            for (int o = 4; o < (4 << nshift); o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
            if ((gq & (ncol - 1)) == 0) skr[(base + j0 + (e & 1)) * P + pr[e >> 1]] = a;
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
      __syncwarp();  // the warp's dqr rows are complete
      // positional half: dq += Wq KE, Wq[i, t] = dqr[i, s] where rel(pix(i), s) = t
      for (int tp = 0; tp < TR / 16; ++tp) {
        float w[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = tp * 16 + 8 * h + 2 * t4 + e;
            const int dy = t / W2, dx = t - dy * W2;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int s = w_col(py[r], px[r], dy, dx, p.wh, p.ww, false);
              w[h][2 * r + e] = s >= 0 ? sqr[ri[r] * P + s] : 0.f;
            }
          }
        uint32_t a[4];
        c_to_a(a, w[0], w[1]);
#pragma unroll
        for (int nd = 0; nd < NTD / 2; ++nd) {
          uint32_t b[4];
          load_b_cols(b, stbl + HD, TS, tp * 16, nd * 16, lane);  // ke columns
          mma_bf16(dqa[2 * nd], a, b[0], b[1]);
          mma_bf16(dqa[2 * nd + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bf16* dst = dqkv + static_cast<long long>(stok[ri[r]]) * C3 + head * HD + 2 * t4;
#pragma unroll
        for (int n = 0; n < NTD; ++n)
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
              __floats2bfloat162_rn(dqa[n][2 * r] * p.scale, dqa[n][2 * r + 1] * p.scale);
      }
    }
    __syncthreads();  // P, dS, dqr, dkr and mass of the group are complete

    // ---- 4. column pass: dk = dS^T Q + Wk QE, dv = P^T G for the warp's 16 keys ----
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
      // positional half: Wk[j, t] = dkr[j, p] where rel(p, pix(j)) = t
      for (int tp = 0; tp < TR / 16; ++tp) {
        float w[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = tp * 16 + 8 * h + 2 * t4 + e;
            const int dy = t / W2, dx = t - dy * W2;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int s = w_col(py[r], px[r], dy, dx, p.wh, p.ww, true);
              w[h][2 * r + e] = s >= 0 ? skr[ri[r] * P + s] : 0.f;
            }
          }
        uint32_t a[4];
        c_to_a(a, w[0], w[1]);
#pragma unroll
        for (int nd = 0; nd < NTD / 2; ++nd) {
          uint32_t b[4];
          load_b_cols(b, stbl, TS, tp * 16, nd * 16, lane);  // qe columns
          mma_bf16(dka[2 * nd], a, b[0], b[1]);
          mma_bf16(dka[2 * nd + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bf16* dst = dqkv + static_cast<long long>(stok[ri[r]]) * C3 + head * HD + 2 * t4;
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(dst + p.C + n * 8) =
              __floats2bfloat162_rn(dka[n][2 * r] * p.scale, dka[n][2 * r + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(dst + 2 * p.C + n * 8) =
              __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
        }
      }
    }

    // ---- 5. table cotangent: units (16 table rows, component), each owned
    // by one warp; q columns scale Wk^T K, k columns scale Wq^T Q, v
    // columns Wm^T G over the group's valid rows, added to the partial ----
    for (int u = warp; u < 3 * (TR / 16); u += nwarps) {
      const int mt = u / 3, comp = u - 3 * mt;
      const bool key = comp == 0;
      const float* wsrc = comp == 0 ? skr : comp == 1 ? sqr : sgve;
      const bf16* bsrc = comp == 0 ? sk : comp == 1 ? sq : sg;
      const float fac = comp < 2 ? p.scale : 1.f;
      int tr[2], dy[2], dx[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tr[h] = mt * 16 + gq + 8 * h;
        dy[h] = tr[h] / W2;
        dx[h] = tr[h] - dy[h] * W2;
      }
      float acc[NTD][4], prev[NTD][4];
#pragma unroll
      for (int n = 0; n < NTD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = prev[n][e] = 0.f;
      if (grp != blockIdx.x) {  // the partial so far (loaded first: its latency overlaps)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (tr[h] >= trows) continue;
#pragma unroll
          for (int n = 0; n < NTD; ++n) {
            const float2 x = *reinterpret_cast<const float2*>(
                part + tr[h] * C3 + comp * HD + n * 8 + 2 * t4);
            prev[n][2 * h] = x.x;
            prev[n][2 * h + 1] = x.y;
          }
        }
      }
      for (int kc = 0; kc < nvalid * MT; ++kc) {
        float w[2][4];  // A[t][j] = W[j][t]: rows t (tr), cols j
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = kc * 16 + 8 * h + 2 * t4 + e;  // group row
            const int pj = (j % T) >> nshift, jy = pj / p.ww, jx = pj - jy * p.ww;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int s = w_col(jy, jx, dy[r], dx[r], p.wh, p.ww, key);
              w[h][2 * r + e] = s >= 0 ? wsrc[j * P + s] : 0.f;
            }
          }
        // W as bf16 hi + lo parts: the sum over every window of the batch
        // keeps about 16 bits of each term, where bf16 alone (8) would lose
        // the tolerance at the training batch
        float wlo[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            wlo[h][e] = w[h][e] - __bfloat162float(__float2bfloat16(w[h][e]));
        uint32_t a[4], alo[4];
        c_to_a(a, w[0], w[1]);
        c_to_a(alo, wlo[0], wlo[1]);
#pragma unroll
        for (int nd = 0; nd < NTD / 2; ++nd) {
          uint32_t b[4];
          load_b_cols(b, bsrc, LD, kc * 16, nd * 16, lane);
          mma_bf16(acc[2 * nd], a, b[0], b[1]);
          mma_bf16(acc[2 * nd + 1], a, b[2], b[3]);
          mma_bf16(acc[2 * nd], alo, b[0], b[1]);
          mma_bf16(acc[2 * nd + 1], alo, b[2], b[3]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (tr[h] >= trows) continue;
#pragma unroll
        for (int n = 0; n < NTD; ++n)
          *reinterpret_cast<float2*>(part + tr[h] * C3 + comp * HD + n * 8 + 2 * t4) =
              make_float2(prev[n][2 * h] + acc[n][2 * h] * fac,
                          prev[n][2 * h + 1] + acc[n][2 * h + 1] * fac);
      }
    }
    __syncthreads();  // the next group overwrites the staged rows and blocks
  }
}

template <int HD, int MT>
int launch_pos_mma(const void* qkv, const float* table, const void* g, void* dqkv,
                   float* partial, PosBwdParams p, int nshift, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(window_pos_bwd_mma_kernel<HD, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_pos_bwd_mma_kernel<HD, MT><<<dim3(p.nblk, p.heads), p.wpb * MT * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), table, static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
      partial, p, nshift);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_pos_bwd(const void* qkv, const float* table, const void* g, void* dqkv, float* partial,
                   float* dtable, PosBwdParams p, cudaStream_t stream) {
  const int P = p.wh * p.ww;
  const int Tw = P * p.N;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int err = -1;  // -1: the main kernel not launched yet
  if constexpr (sizeof(T) == 2) {
    const int nshift = p.N == 1 ? 0 : p.N == 2 ? 1 : p.N == 4 ? 2 : p.N == 8 ? 3 : -1;
    const int mt = Tw % 16 == 0 ? Tw / 16 : 0;
    size_t a, b, c, d;
    const size_t smem =
        pos_mma_smem<HD>(p.wpb * Tw, P, Tw, p.wpb, (trows + 15) / 16 * 16, &a, &b, &c, &d);
    if (nshift >= 0 && smem <= static_cast<size_t>(max_smem)) {
      if (mt == 1) err = launch_pos_mma<HD, 1>(qkv, table, g, dqkv, partial, p, nshift, smem, stream);
      if (mt == 9) err = launch_pos_mma<HD, 9>(qkv, table, g, dqkv, partial, p, nshift, smem, stream);
    }
  }
  if (err == -1) {
    p.keep_table = pos_bwd_smem_bytes<T, HD>(p.wpb * Tw, P, Tw, trows, 1) <=
                   static_cast<size_t>(max_smem);
    const size_t smem = pos_bwd_smem_bytes<T, HD>(p.wpb * Tw, P, Tw, trows, p.keep_table);
    e = cudaFuncSetAttribute(window_pos_bwd_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    window_pos_bwd_kernel<T, HD><<<dim3(p.nblk, p.heads), kPosWarps * 32, smem, stream>>>(
        static_cast<const T*>(qkv), table, static_cast<const T*>(g), static_cast<T*>(dqkv),
        partial, p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0) return err;
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
