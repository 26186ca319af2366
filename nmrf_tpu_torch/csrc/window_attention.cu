// Shifted-window NMP attention with relative-position q/k/v terms (K1).
//
// Replaces nmrf_tpu/ops/pallas/attention.py:_window_native_kernel_direct
// (and the transposed _window_native_kernel, which computes the same
// function), driven by window_attention_native / _wan_core.
//
// Function, per window w and head h (tokens i, j of the window in
// (row, col, candidate) order, pix(i) the pixel of token i):
//   logit[i,j] = scale * (q_i.k_j + q_i.ke[pix(i),pix(j)] + k_j.qe[pix(i),pix(j)])
//                + candidate mask + shifted-region mask
//   out_i = sum_j a_ij v_j + sum_s (sum_{j: pix(j)=s} a_ij) ve[pix(i), s]
// with a = softmax_j(logit) and qe/ke/ve the three hd-slices of this head in
// the relative-position table row rel(pix(i), s).  The masks are computed
// from token coordinates: a candidate never sees another candidate of its
// own pixel (Inference), and with shift > 0 tokens of different regions of
// the rolled image (boundaries at Hp-wh, Hp-shift, Wp-ww, Wp-shift) never
// see each other.  Under H-sharding the input is one tile of the image: the
// region rows are then global, y = row0 + local y against the global padded
// height hp_total (row0 = 0 and hp_total = Hp for an unsharded image).
//
// Both versions below give a block one head's window groups: a group is one
// window at T = wh*ww*N >= 128 tokens (Inference: 6x6x4 = 144) and
// floor(128 / T) windows otherwise (Refinement: 4x4x1 = 16 -> 8 windows per
// block).  Softmax and every sum are f32, for f32 and bf16 inputs alike.
//
// bf16 with N in {1, 2, 4, 8} and T = 16 or 144 (the serving and training
// launches), 16-byte aligned qkv and out: the tensor-core kernel,
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation fed by ldmatrix
// (csrc/mma.cuh), one warp per 16 query rows (9 warps at Inference, 8
// windows of one warp at Refinement).  The grid holds as many blocks as run
// at once, spread over the heads; block (b, head) walks the groups b, b +
// gridDim.x, ...  Per block, once:
//   0. the head's qe | ke | ve table columns staged as bf16 with 16-byte
//      loads (the wrapper rounds the table to qkv's dtype, so exactly), and
//      the pixel index scol[p, t] = s with rel(p, s) = t (-1 where no pixel
//      of the window matches; rel(s, p) = trows - 1 - rel(p, s));
// per group, stages 1-2 as K1b's (window_attention_bwd.cu):
//   1. the token and shifted region of each row, with global rows row0 + y
//      against hp_total; q, k and v rows to shared memory by 16-byte
//      cp.async, padded to HD + 8 (no ldmatrix bank conflict);
//   2. qr[i,s] = scale q_i.ke[rel(pix(i),s)] and kr[j,p] = scale
//      k_j.qe[rel(p,pix(j))] (f32 [rows, P]): Q and K against every staged
//      table row on the tensor cores, each result scattered to the pixel
//      that scol gives for that row;
//   3. one sweep over 16-key chunks with an online softmax: S = scale Q K^T
//      + qr + kr + masks in the fragment, the row max updated per chunk
//      (quad shuffles), the running sum and O rescaled when it grows, O +=
//      P V with P = exp(S - max) rounded to bf16 only as the mma operand.
//      The chunk's attention mass per key pixel (its N adjacent key columns
//      summed with shuffles inside the quad) replaces the chunk's qr
//      entries, which only this warp reads, and the row's running max after
//      the chunk is kept ([rows, MT] f32): one pass then rescales every
//      mass to the final max.  One sweep and not two (max, then P): the
//      logits' elementwise part (two positional loads, two region loads and
//      the masks per logit) costs more than the rescale's P exponentials a
//      row, and two sweeps would do it twice;
//   4. the value-table term is one more product, O += Wm VE, with Wm[i, t]
//      = mass(i, s) where rel(pix(i), s) = t (gathered through scol; B7's
//      W form) and VE the staged ve columns, Wm rounded to bf16 as the mma
//      operand;
//   5. out = O / sum, through the warp's own q rows in shared memory to
//      16-byte stores.
// Shared memory at Inference (hd 32): 34,560 B of rows, 41,472 of qr | kr,
// 26,624 of table, 5,184 of chunk maxima, 1,152 of ids, 4,608 of pixel
// index: 113,600, so two 9-warp blocks share an SM (the 112 registers a
// thread may then have hold it without spilling); 62,976 at Refinement.
//
// f32 (the phase 3 and 4 checks at 1e-4, which TF32 would not meet) and
// bf16 at other shapes (the entry reports which kernel it launched through
// ``variant``: 1 the tensor-core kernel, 0 this one): the CUDA-core kernel,
// 8 warps, one block per group:
//   1. q, k, v rows of the group go to shared memory in the input's dtype;
//   2. the head's qe|ke table columns are staged in shared memory, and the
//      pixel-granular positional terms qr and kr computed once per block
//      (T*P*hd MACs each); row strides are odd in 32-bit words, so the
//      column reads are free of bank conflicts;
//   3. each warp owns query rows: the logits of one row live in a per-warp
//      shared row, the softmax is two warp reductions, and lanes own output
//      channels for a.v; the row is then folded to its attention mass per
//      key pixel, and lanes own channels again for the value-table term (ve
//      read from the table in global memory, coalesced across lanes).
//
// Bound on the H100 (bf16, KITTI main path, Inference): the launch must
// move about 31 MB (9 us at 3.35 TB/s) and do about 3 GFLOP (3 us on the
// bf16 tensor cores), so the bound is the bytes.  `chip_smoke.py
// --k1-stages` times the tensor-core kernel with each of stages 2-4 cut out
// in turn, which shows what holds it above the bound (PERF.md).

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace nmrf {

struct WindowParams {
  int B, Hp, Wp, N, C, heads, wh, ww, shift, candidate_mask, wpb, nwin;
  int row0, hp_total;  // global row of local row 0; global padded height
  float scale;
};

constexpr int kWinWarps = 8;

__device__ __forceinline__ int rel_index(int p, int s, int wh, int ww) {
  const int py = p / ww, px = p % ww, sy = s / ww, sx = s % ww;
  return (py - sy + wh - 1) * (2 * ww - 1) + (px - sx + ww - 1);
}

// row stride (in elements) of the staged q/k/v rows: an odd number of
// 32-bit words, so lanes reading different rows hit different banks
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() { return sizeof(T) == 4 ? HD + 1 : HD + 2; }

template <typename T, int HD>
inline size_t window_smem_bytes(int rows, int P, int Tw, int trows) {
  const size_t qkv = static_cast<size_t>(3) * rows * row_stride<T, HD>() * sizeof(T);
  const size_t qkv_aligned = (qkv + 15) / 16 * 16;
  const size_t pos = static_cast<size_t>(2) * rows * P * sizeof(float);
  const size_t scratch_rows = static_cast<size_t>(kWinWarps) * Tw;
  const size_t scratch_tbl = static_cast<size_t>(trows) * (2 * HD + 1);
  return qkv_aligned + pos + sizeof(float) * (scratch_rows > scratch_tbl ? scratch_rows : scratch_tbl);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWinWarps * 32)
window_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ table,
                        T* __restrict__ out, WindowParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = row_stride<T, HD>();
  constexpr int TS = 2 * HD + 1;  // staged table row stride (qe | ke), odd
  const int P = p.wh * p.ww;
  const int Tw = P * p.N;
  const int rows = p.wpb * Tw;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  const int C3 = 3 * p.C;
  T* sq = reinterpret_cast<T*>(smem_raw);  // [rows, RS]
  T* sk = sq + rows * RS;
  T* sv = sk + rows * RS;
  const size_t qkv_bytes = (static_cast<size_t>(3) * rows * RS * sizeof(T) + 15) / 16 * 16;
  float* sqr = reinterpret_cast<float*>(smem_raw + qkv_bytes);  // [rows, P]
  float* skr = sqr + rows * P;                                  // [rows, P]
  float* scratch = skr + rows * P;  // staged table, then one softmax row per warp

  const int head = blockIdx.y;
  const int nwh = p.Hp / p.wh, nww = p.Wp / p.ww;
  const int tcol = head * 3 * HD;  // this head's (qe | ke | ve) columns

  // token r of the block -> flat token index in [B, Hp, Wp, N], -1 if the
  // block's last group runs past the window count
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
    T qv = from_float<T>(0.f), kv = qv, vv = qv;
    if (tok >= 0) {
      const T* src = qkv + tok * C3 + head * HD + c;
      qv = src[0];
      kv = src[p.C];
      vv = src[2 * p.C];
    }
    sq[r * RS + c] = qv;
    sk[r * RS + c] = kv;
    sv[r * RS + c] = vv;
  }
  for (int idx = threadIdx.x; idx < trows * 2 * HD; idx += blockDim.x) {
    const int t = idx / (2 * HD), c = idx % (2 * HD);
    scratch[t * TS + c] = __ldg(table + static_cast<long long>(t) * C3 + tcol + c);
  }
  __syncthreads();

  // pixel-granular positional logits (scale folded in)
  for (int idx = threadIdx.x; idx < rows * P; idx += blockDim.x) {
    const int r = idx / P, s = idx % P;
    const int pix = (r % Tw) / p.N;
    const float* ke = scratch + rel_index(pix, s, p.wh, p.ww) * TS + HD;
    const float* qe = scratch + rel_index(s, pix, p.wh, p.ww) * TS;
    const T* qr_ = sq + r * RS;
    const T* kr_ = sk + r * RS;
    float aq = 0.f, ak = 0.f;
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      aq += to_float(qr_[c]) * ke[c];
      ak += to_float(kr_[c]) * qe[c];
    }
    sqr[r * P + s] = aq * p.scale;
    skr[r * P + s] = ak * p.scale;
  }
  __syncthreads();  // the staged table is dead from here; scratch holds rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* row = scratch + warp * Tw;
  for (int r = warp; r < rows; r += kWinWarps) {
    const long long tok = token_of(r);
    if (tok < 0) break;  // rows past the window count are all at the end
    const int base = (r / Tw) * Tw;
    const int ti = r % Tw;
    const int pix_i = ti / p.N;
    const int win = blockIdx.x * p.wpb + r / Tw;
    const int rem = win % (nwh * nww);
    const int gy = (rem / nww) * p.wh, gx = (rem % nww) * p.ww;
    auto region = [&](int t) {
      const int y = p.row0 + gy + (t / p.N) / p.ww, x = gx + (t / p.N) % p.ww;
      const int ry = (y >= p.hp_total - p.wh) + (y >= p.hp_total - p.shift);
      const int rx = (x >= p.Wp - p.ww) + (x >= p.Wp - p.shift);
      return 3 * ry + rx;
    };
    const int reg_i = p.shift > 0 ? region(ti) : 0;

    float qi[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) qi[c] = to_float(sq[r * RS + c]);
    float mx = -INFINITY;
    for (int j = lane; j < Tw; j += 32) {
      const int pix_j = j / p.N;
      const T* kj = sk + (base + j) * RS;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += 2) {
        s0 += qi[c] * to_float(kj[c]);
        s1 += qi[c + 1] * to_float(kj[c + 1]);
      }
      float s = (s0 + s1) * p.scale + sqr[r * P + pix_j] + skr[(base + j) * P + pix_i];
      if (p.candidate_mask && pix_j == pix_i && j != ti) s += kNegInf;
      if (p.shift > 0 && region(j) != reg_i) s += kNegInf;
      row[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Tw; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    const float inv = 1.f / sum;
    constexpr int NC = (HD + 31) / 32;  // output channels per lane
    float acc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = k * 32 + lane;
      acc[k] = 0.f;
      if (c < HD) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        const T* vc = sv + base * RS + c;
        int j = 0;
        for (; j + 4 <= Tw; j += 4) {
          a0 += row[j] * to_float(vc[j * RS]);
          a1 += row[j + 1] * to_float(vc[(j + 1) * RS]);
          a2 += row[j + 2] * to_float(vc[(j + 2) * RS]);
          a3 += row[j + 3] * to_float(vc[(j + 3) * RS]);
        }
        for (; j < Tw; ++j) a0 += row[j] * to_float(vc[j * RS]);
        acc[k] = (a0 + a1) + (a2 + a3);
      }
    }
    // attention mass per key pixel (P <= 64), written over the row's head
    float mass[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = k * 32 + lane;
      if (s < P)
        for (int n = 0; n < p.N; ++n) mass[k] += row[s * p.N + n];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (k * 32 + lane < P) row[k * 32 + lane] = mass[k];
    __syncwarp();
    // value-table term: ve[rel(pix_i, s)], rows walked without divisions
    const int py = pix_i / p.ww, px = pix_i % p.ww;
    const float* ve = table + tcol + 2 * HD;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = k * 32 + lane;
      if (c < HD) {
        float a = acc[k];
        for (int sy = 0; sy < p.wh; ++sy) {
          const float* vrow = ve + static_cast<long long>((py - sy + p.wh - 1) * (2 * p.ww - 1) +
                                                          px + p.ww - 1) * C3 + c;
          for (int sx = 0; sx < p.ww; ++sx)
            a += row[sy * p.ww + sx] * __ldg(vrow - static_cast<long long>(sx) * C3);
        }
        out[tok * p.C + head * HD + c] = from_float<T>(a * inv);
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaMaxWarps = 9;             // one warp per 16 rows of a window group

// byte offsets of the tensor-core kernel's shared memory: q|k|v rows
// [rows, HD + 8] bf16, qr|kr [rows, P] f32 (qr later holds the mass), the
// staged table [TR, 3 HD + 8] bf16, the running row max after each chunk
// [rows, MT] f32, the token and region ids [rows] int, the pixel index
// [P, TR] int8; returns the total
template <int HD>
__host__ __device__ inline size_t mma_smem(int rows, int P, int MT, int TR, size_t* pos_off,
                                           size_t* tbl_off, size_t* mx_off, size_t* int_off,
                                           size_t* col_off) {
  const size_t tok = static_cast<size_t>(3) * rows * (HD + 8) * sizeof(bf16);
  const size_t pos = static_cast<size_t>(2) * rows * P * sizeof(float);
  const size_t tbl = static_cast<size_t>(TR) * (3 * HD + 8) * sizeof(bf16);
  *pos_off = tok;
  *tbl_off = tok + pos;
  *mx_off = *tbl_off + tbl;
  *int_off = *mx_off + static_cast<size_t>(rows) * MT * sizeof(float);
  *col_off = *int_off + static_cast<size_t>(2) * rows * sizeof(int);
  return *col_off + static_cast<size_t>(P) * TR;
}

// MT 16-row tiles per window (T = 16 MT); N = 1 << nshift candidates.  Block
// (b, head) walks the window groups b, b + gridDim.x, ...
template <int HD, int MT>
__global__ void __launch_bounds__(kMmaMaxWarps * 32, HD <= 32 ? 2 : 1)
window_attention_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ table,
                            bf16* __restrict__ out, WindowParams p, int nshift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int T = 16 * MT, LD = HD + 8, KS = HD / 16, NTD = HD / 8;
  constexpr int TS = 3 * HD + 8;  // staged table row (qe | ke | ve)
  constexpr int CH = HD / 8;      // 16-byte chunks of a row
  const int P = p.wh * p.ww;
  const int rows = p.wpb * T;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  const int TR = (trows + 15) / 16 * 16;
  const int W2 = 2 * p.ww - 1;
  const int C3 = 3 * p.C;
  size_t pos_off, tbl_off, mx_off, int_off, col_off;
  mma_smem<HD>(rows, P, MT, TR, &pos_off, &tbl_off, &mx_off, &int_off, &col_off);
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [rows, LD] each
  bf16* sk = sq + rows * LD;
  bf16* sv = sk + rows * LD;
  float* sqr = reinterpret_cast<float*>(smem_raw + pos_off);  // [rows, P]: qr, then mass
  float* skr = sqr + rows * P;                                // [rows, P]
  bf16* stbl = reinterpret_cast<bf16*>(smem_raw + tbl_off);   // [TR, TS]
  float* smx = reinterpret_cast<float*>(smem_raw + mx_off);   // [rows, MT]
  int* stok = reinterpret_cast<int*>(smem_raw + int_off);     // token of each row, -1 past nwin
  int* sreg = stok + rows;                                    // shifted region of each row
  signed char* scol = reinterpret_cast<signed char*>(smem_raw + col_off);  // [P, TR]

  const int head = blockIdx.y;
  const int nwh = p.Hp / p.wh, nww = p.Wp / p.ww;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;

  // ---- 0. once per block: the head's table columns as bf16, and the pixel
  // index scol[p, t] = s with rel(p, s) = t, -1 where none (rel(s, p) =
  // trows - 1 - rel(p, s), so the key side reads it at trows - 1 - t) ----
  for (int idx = threadIdx.x; idx < TR * (3 * HD / 4); idx += blockDim.x) {
    const int t = idx / (3 * HD / 4), c = (idx % (3 * HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < trows)
      x = __ldg(reinterpret_cast<const float4*>(table + static_cast<long long>(t) * C3 +
                                                head * 3 * HD + c));
    *reinterpret_cast<uint2*>(stbl + t * TS + c) =
        make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
  for (int idx = threadIdx.x; idx < P * TR; idx += blockDim.x) {
    const int pix = idx / TR, t = idx - pix * TR;
    const int sy = pix / p.ww + p.wh - 1 - t / W2;
    const int sx = pix % p.ww + p.ww - 1 - t % W2;
    scol[idx] = static_cast<signed char>(
        t < trows && sy >= 0 && sy < p.wh && sx >= 0 && sx < p.ww ? sy * p.ww + sx : -1);
  }

  // this warp: rows r0w.. of window wi of a group, its row tile rt
  const int r0w = warp * 16, wi = warp / MT, rt = warp % MT;
  const int base = wi * T;  // group row of the window's token 0
  int ti[2], ri[2], pr[2];  // the thread's two rows: token, group row, pixel
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ti[r] = rt * 16 + gq + 8 * r;
    ri[r] = base + ti[r];
    pr[r] = ti[r] >> nshift;
  }
  const int ncol = 1 << nshift;  // key tokens of a pixel
  const int ngroups = (p.nwin + p.wpb - 1) / p.wpb;

  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const int win0 = grp * p.wpb;
    // ---- 1. token and region ids, the q|k|v rows ----
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
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const int tok = stok[r];
      const bool valid = tok >= 0;
      const long long src = valid ? static_cast<long long>(tok) * C3 + head * HD + c : 0;
      cp_async16(sq + r * LD + c, qkv + src, valid);
      cp_async16(sk + r * LD + c, qkv + src + p.C, valid);
      cp_async16(sv + r * LD + c, qkv + src + 2 * p.C, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // ---- 2. positional blocks: Q and K against every table row ----
    {
      uint32_t qa[KS][4], ka[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        load_a(qa[ks], sq, LD, r0w, ks * 16, lane);
        load_a(ka[ks], sk, LD, r0w, ks * 16, lane);
      }
      // each result to the pixel s with rel(pix, s) (qr) or rel(s, pix)
      // (kr) equal to its table row
      for (int tp = 0; tp < TR / 16; ++tp) {
        float cq[2][4] = {}, ck[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[4];
          load_b_rows(b, stbl + HD, TS, tp * 16, ks * 16, lane);  // ke columns
          mma_bf16(cq[0], qa[ks], b[0], b[1]);
          mma_bf16(cq[1], qa[ks], b[2], b[3]);
          load_b_rows(b, stbl, TS, tp * 16, ks * 16, lane);  // qe columns
          mma_bf16(ck[0], ka[ks], b[0], b[1]);
          mma_bf16(ck[1], ka[ks], b[2], b[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = tp * 16 + nt * 8 + 2 * t4 + (e & 1), r = e >> 1;
            if (t >= trows) continue;
            int s = scol[pr[r] * TR + t];
            if (s >= 0) sqr[ri[r] * P + s] = cq[nt][e] * p.scale;
            s = scol[pr[r] * TR + trows - 1 - t];
            if (s >= 0) skr[ri[r] * P + s] = ck[nt][e] * p.scale;
          }
      }
    }
    __syncthreads();  // kr[j, .] is read by the warps of the query rows

    if (win0 + wi < p.nwin) {
      // ---- 3. one sweep over 16-key chunks: online softmax, O += P V, mass ----
      uint32_t qa[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) load_a(qa[ks], sq, LD, r0w, ks * 16, lane);
      const bf16* wk = sk + base * LD;
      const bf16* wv = sv + base * LD;
      const int reg_i[2] = {sreg[ri[0]], sreg[ri[1]]};
      float o[NTD][4];
#pragma unroll
      for (int n = 0; n < NTD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
      for (int kp = 0; kp < MT; ++kp) {
        float s[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[4];
          load_b_rows(b, wk, LD, kp * 16, ks * 16, lane);
          mma_bf16(s[0], qa[ks], b[0], b[1]);
          mma_bf16(s[1], qa[ks], b[2], b[3]);
        }
        // logits: scale Q K^T + qr[i, pix(j)] + kr[j, pix(i)] + masks
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, j = kp * 16 + c * 8 + 2 * t4 + (e & 1), pj = j >> nshift;
            float x = s[c][e] * p.scale + sqr[ri[r] * P + pj] + skr[(base + j) * P + pr[r]];
            if ((p.candidate_mask && pj == pr[r] && j != ti[r]) ||
                (p.shift > 0 && reg_i[r] != sreg[base + j]))
              x += kNegInf;
            s[c][e] = x;
          }
        // online softmax: the new row max rescales the running sum and O
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(mx[r], quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                                       fmaxf(s[1][2 * r], s[1][2 * r + 1]))));
          const float alpha = __expf(mx[r] - mn);
          mx[r] = mn;
          sum[r] *= alpha;
#pragma unroll
          for (int n = 0; n < NTD; ++n) {
            o[n][2 * r] *= alpha;
            o[n][2 * r + 1] *= alpha;
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[c][e] = __expf(s[c][e] - mx[e >> 1]);
            sum[e >> 1] += s[c][e];
          }
        __syncwarp();  // every lane has read the chunk's qr entries
        // the chunk's mass per key pixel replaces those qr entries
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j0 = kp * 16 + c * 8 + 2 * t4;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (ncol == 1) {
              sqr[ri[r] * P + j0] = s[c][2 * r];
              sqr[ri[r] * P + j0 + 1] = s[c][2 * r + 1];
            } else {
              float m = s[c][2 * r] + s[c][2 * r + 1];
              for (int off = 1; off < ncol / 2; off <<= 1)
                m += __shfl_xor_sync(0xffffffffu, m, off);
              if ((t4 & (ncol / 2 - 1)) == 0) sqr[ri[r] * P + (j0 >> nshift)] = m;
            }
          }
        }
        if (t4 == 0) {
          smx[ri[0] * MT + kp] = mx[0];
          smx[ri[1] * MT + kp] = mx[1];
        }
        uint32_t a[4];
        c_to_a(a, s[0], s[1]);
#pragma unroll
        for (int nd = 0; nd < NTD / 2; ++nd) {
          uint32_t b[4];
          load_b_cols(b, wv, LD, kp * 16, nd * 16, lane);
          mma_bf16(o[2 * nd], a, b[0], b[1]);
          mma_bf16(o[2 * nd + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) sum[r] = quad_sum(sum[r]);
      __syncwarp();  // the warp's mass rows and chunk maxima are complete
      // every mass to the row's final max (the chunk of key pixel s is (s N) / 16)
      for (int idx = lane; idx < 16 * P; idx += 32) {
        const int row = r0w + idx / P, s = idx % P;
        sqr[row * P + s] *= __expf(smx[row * MT + ((s << nshift) >> 4)] - smx[row * MT + MT - 1]);
      }
      __syncwarp();

      // ---- 4. value-table term: O += Wm VE, Wm[i, t] = mass(i, s), rel(pix(i), s) = t ----
      for (int tp = 0; tp < TR / 16; ++tp) {
        float w[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = tp * 16 + 8 * h + 2 * t4 + e;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int s = scol[pr[r] * TR + t];
              w[h][2 * r + e] = s >= 0 ? sqr[ri[r] * P + s] : 0.f;
            }
          }
        uint32_t a[4];
        c_to_a(a, w[0], w[1]);
#pragma unroll
        for (int nd = 0; nd < NTD / 2; ++nd) {
          uint32_t b[4];
          load_b_cols(b, stbl + 2 * HD, TS, tp * 16, nd * 16, lane);  // ve columns
          mma_bf16(o[2 * nd], a, b[0], b[1]);
          mma_bf16(o[2 * nd + 1], a, b[2], b[3]);
        }
      }

      // ---- 5. out = O / sum, through the warp's own q rows to 16-byte stores ----
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float inv = 1.f / sum[r];
        bf16* dst = sq + (r0w + gq + 8 * r) * LD + 2 * t4;
#pragma unroll
        for (int n = 0; n < NTD; ++n)
          *reinterpret_cast<uint32_t*>(dst + n * 8) =
              pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      }
      __syncwarp();
      for (int idx = lane; idx < 16 * CH; idx += 32) {
        const int row = r0w + idx / CH, c = (idx % CH) * 8;
        *reinterpret_cast<uint4*>(out + static_cast<long long>(stok[row]) * p.C + head * HD + c) =
            *reinterpret_cast<const uint4*>(sq + row * LD + c);
      }
    }
    __syncthreads();  // the group's rows and ids are dead: the next group restages them
  }
}

template <int HD, int MT>
int launch_mma(const void* qkv, const float* table, void* out, WindowParams p, int nshift,
               size_t smem, cudaStream_t stream) {
  // as many blocks as run at once, spread over the heads: each stages its
  // head's table and pixel index once and walks its share of the groups
  const int threads = p.wpb * MT * 32;
  const int ngroups = (p.nwin + p.wpb - 1) / p.wpb;
  int blocks = 0;
  const cudaError_t err = launch_config(window_attention_mma_kernel<HD, MT>, threads,
                                        static_cast<int>(smem), ngroups * p.heads, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_mma_kernel<HD, MT><<<dim3((blocks + p.heads - 1) / p.heads, p.heads),
                                        threads, smem, stream>>>(
      static_cast<const bf16*>(qkv), table, static_cast<bf16*>(out), p, nshift);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* qkv, const float* table, void* out, WindowParams p, cudaStream_t stream,
           int* variant) {
  const int P = p.wh * p.ww;
  const int Tw = P * p.N;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  if constexpr (sizeof(T) == 2) {
    const int nshift = p.N == 1 ? 0 : p.N == 2 ? 1 : p.N == 4 ? 2 : p.N == 8 ? 3 : -1;
    const int mt = Tw % 16 == 0 ? Tw / 16 : 0;
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    size_t a, b, c, d, e;
    const size_t smem =
        mma_smem<HD>(p.wpb * Tw, P, mt, (trows + 15) / 16 * 16, &a, &b, &c, &d, &e);
    if (nshift >= 0 && aligned && smem <= kMaxBlockSmem && (mt == 1 || mt == 9)) {
      *variant = 1;
      if (mt == 1) return launch_mma<HD, 1>(qkv, table, out, p, nshift, smem, stream);
      return launch_mma<HD, 9>(qkv, table, out, p, nshift, smem, stream);
    }
  }
  *variant = 0;
  const size_t smem = window_smem_bytes<T, HD>(p.wpb * Tw, P, Tw, trows);
  const cudaError_t err = ensure_smem(window_attention_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nwin + p.wpb - 1) / p.wpb, p.heads);
  window_attention_kernel<T, HD><<<grid, kWinWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), table, static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* qkv, const float* table, void* out, WindowParams p,
                cudaStream_t s, int* variant) {
  switch (hd) {
    case 16: return launch<T, 16>(qkv, table, out, p, s, variant);
    case 32: return launch<T, 32>(qkv, table, out, p, s, variant);
    case 64: return launch<T, 64>(qkv, table, out, p, s, variant);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nmrf

extern "C" int nmrf_window_attention(const void* qkv, const void* table, void* out,
                                     int dtype, int B, int Hp, int Wp, int N, int C,
                                     int heads, int wh, int ww, int shift,
                                     int candidate_mask, int row0, int hp_total,
                                     float scale, void* stream, int* variant) {
  using namespace nmrf;
  WindowParams p;
  p.B = B; p.Hp = Hp; p.Wp = Wp; p.N = N; p.C = C; p.heads = heads;
  p.wh = wh; p.ww = ww; p.shift = shift;
  p.candidate_mask = candidate_mask; p.scale = scale;
  p.row0 = row0; p.hp_total = hp_total;
  const int Tw = wh * ww * N;
  if (wh * ww > 64) return static_cast<int>(cudaErrorInvalidValue);  // P <= 64
  p.wpb = Tw >= 128 ? 1 : 128 / Tw;
  p.nwin = B * (Hp / wh) * (Wp / ww);
  const float* tbl = static_cast<const float*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_hd<float>(C / heads, qkv, tbl, out, p, s, variant);
  if (dtype == kBF16) return dispatch_hd<__nv_bfloat16>(C / heads, qkv, tbl, out, p, s, variant);
  return static_cast<int>(cudaErrorInvalidValue);
}
