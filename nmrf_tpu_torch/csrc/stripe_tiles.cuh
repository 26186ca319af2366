// Stripe addressing and the tile loader of the tensor-core stripe kernels
// (K2's forward and K2b's two backward kernels): blocks of 4 warps own 64
// rows, 16 per warp, and the other side's rows stream through shared memory
// 64 at a time with 16-byte cp.async, rows padded to HD + 8 elements so
// ldmatrix has no bank conflict.  Inputs stay in the padded image layout
// [B, Hp, Wp, N, C]; a token's head slice is 2 HD contiguous bytes.
#pragma once

#include "mma.cuh"

namespace nmrf {

struct StripeParams {
  int B, Hp, Wp, N, C, heads, H_sp, W_sp, ni, nj, T;
  float scale;
};

inline StripeParams stripe_params(int B, int Hp, int Wp, int N, int C, int heads, int H_sp,
                                  int W_sp, float scale) {
  StripeParams p;
  p.B = B; p.Hp = Hp; p.Wp = Wp; p.N = N; p.C = C; p.heads = heads;
  p.H_sp = H_sp; p.W_sp = W_sp; p.ni = Hp / H_sp; p.nj = Wp / W_sp;
  p.T = H_sp * W_sp * N; p.scale = scale;
  return p;
}

constexpr int kMmaRows = 64;      // rows a block owns (and rows of a streamed tile)
constexpr int kMmaThreads = 128;  // 4 warps of 16 rows

// padded row of a staged tile, in elements (16-byte rows, no ldmatrix conflict)
template <int HD>
__host__ __device__ constexpr int mma_ld() { return HD + 8; }

// offset of the head's slice of stripe token t (the CUDA-core kernels)
__device__ __forceinline__ long long stripe_offset(const StripeParams& p, int stripe,
                                                   int head, int hd, int t) {
  const int b = stripe / (p.ni * p.nj);
  const int si = (stripe / p.nj) % p.ni, sj = stripe % p.nj;
  const int WN = p.W_sp * p.N;
  const int y = si * p.H_sp + t / WN;
  const int x = sj * p.W_sp + (t / p.N) % p.W_sp;
  return (((static_cast<long long>(b) * p.Hp + y) * p.Wp + x) * p.N + t % p.N) * p.C +
         head * hd;
}

// offset of the head's slice of a stripe's first token
__device__ __forceinline__ long long stripe_base(const StripeParams& p, int stripe, int head,
                                                 int hd) {
  const int b = stripe / (p.ni * p.nj);
  const int si = (stripe / p.nj) % p.ni, sj = stripe % p.nj;
  return ((static_cast<long long>(b) * p.Hp + si * p.H_sp) * p.Wp + sj * p.W_sp) * p.N * p.C +
         head * hd;
}

// offset of stripe token t, (row, col, n) over (H_sp, W_sp, N), from the base:
// col * N + n is t's remainder after the rows
__device__ __forceinline__ long long stripe_token(const StripeParams& p, int t) {
  const int WN = p.W_sp * p.N;
  const int dy = t / WN;
  return (static_cast<long long>(dy) * p.Wp * p.N + (t - dy * WN)) * p.C;
}

// rows r0..r0+63 of a stripe's tokens of xa and xb into two [64, HD + 8]
// tiles with cp.async; rows at or past T are zero-filled
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* da, const __nv_bfloat16* xa,
                                           __nv_bfloat16* db, const __nv_bfloat16* xb,
                                           long long base, int r0, const StripeParams& p) {
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  constexpr int LD = mma_ld<HD>();
  const int c = threadIdx.x % CH;
  for (int r = threadIdx.x / CH; r < kMmaRows; r += kMmaThreads / CH) {
    const int t = r0 + r;
    const bool valid = t < p.T;
    const long long off = valid ? base + stripe_token(p, t) + c * 8 : 0;
    cp_async16(da + r * LD + c * 8, xa + off, valid);
    cp_async16(db + r * LD + c * 8, xb + off, valid);
  }
}

// rows r0..r0+63 of one tensor's stripe tokens into a [64, HD + 8] tile
template <int HD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* d, const __nv_bfloat16* x,
                                           long long base, int r0, const StripeParams& p) {
  constexpr int CH = HD / 8;
  constexpr int LD = mma_ld<HD>();
  const int c = threadIdx.x % CH;
  for (int r = threadIdx.x / CH; r < kMmaRows; r += kMmaThreads / CH) {
    const int t = r0 + r;
    const bool valid = t < p.T;
    cp_async16(d + r * LD + c * 8, x + (valid ? base + stripe_token(p, t) + c * 8 : 0), valid);
  }
}

}  // namespace nmrf
