// Shifted-window NMP attention with relative-position q/k/v terms.
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
// Design: one block of 8 warps per (group of windows, head).  A group is one
// window at T = wh*ww*N >= 128 tokens (Inference: 6x6x4 = 144) and
// floor(128 / T) windows otherwise (Refinement: 4x4x1 = 16 -> 8 windows per
// block), so every block stages about 128 token rows.
//   1. q, k, v rows of the group go to shared memory in the input's dtype
//      (bf16 stays bf16: 29 KB at T = 144, so two blocks fit on an SM).
//   2. The head's qe|ke table columns are staged in shared memory, and the
//      pixel-granular positional terms qr[i,s] = scale q_i.ke[pix(i),s] and
//      kr[j,p] = scale k_j.qe[p,pix(j)] are computed once per block (T*P*hd
//      MACs each, a quarter of q.k at T = 144); row strides are odd in
//      32-bit words, so the column reads are free of bank conflicts.
//   3. Each warp owns query rows: the logits of one row live in a per-warp
//      shared row, the softmax is two warp reductions, and lanes own output
//      channels for a.v; the row is then folded to its attention mass per
//      key pixel, and lanes own channels again for the value-table term (ve
//      read from the table in global memory, coalesced across lanes).
// Softmax and every sum are f32, for f32 and bf16 inputs alike.
//
// Bound on the H100 (bf16, KITTI main path, Inference): the launch must
// move about 31 MB (9 us at 3.35 TB/s) and do about 3 GFLOP (3 us on the
// bf16 tensor cores), so the bound is the bytes.  This version does its
// dot products on CUDA cores from shared memory, so shared-memory issue
// bounds it, far above that; mma/wgmma tiles for q.k^T and a.v are the
// next step.

#include "common.cuh"

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

template <typename T, int HD>
int launch(const void* qkv, const float* table, void* out, WindowParams p, cudaStream_t stream) {
  const int P = p.wh * p.ww;
  const int Tw = P * p.N;
  const int trows = (2 * p.wh - 1) * (2 * p.ww - 1);
  const size_t smem = window_smem_bytes<T, HD>(p.wpb * Tw, P, Tw, trows);
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nwin + p.wpb - 1) / p.wpb, p.heads);
  window_attention_kernel<T, HD><<<grid, kWinWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), table, static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* qkv, const float* table, void* out, WindowParams p,
                cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(qkv, table, out, p, s);
    case 32: return launch<T, 32>(qkv, table, out, p, s);
    case 64: return launch<T, 64>(qkv, table, out, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nmrf

extern "C" int nmrf_window_attention(const void* qkv, const void* table, void* out,
                                     int dtype, int B, int Hp, int Wp, int N, int C,
                                     int heads, int wh, int ww, int shift,
                                     int candidate_mask, int row0, int hp_total,
                                     float scale, void* stream) {
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
  if (dtype == kF32) return dispatch_hd<float>(C / heads, qkv, tbl, out, p, s);
  if (dtype == kBF16) return dispatch_hd<__nv_bfloat16>(C / heads, qkv, tbl, out, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
