// Dense addressing and the staging helpers of the tensor-core masked
// attention kernels (B6's forward and B6b's two backward kernels).
//
// Layouts: q (and g, dq) [h, G, Rq, hd], k and v [h, G, Rk, hd], so the rows
// of one (head, group) pair are contiguous, [R, hd] at (head G + g) R hd;
// mask [Gm, Rq, Rk] f32, group g reads mask[g % Gm].  Rows stream through
// shared memory with 16-byte cp.async into rows padded to HD + 8 elements
// (mma_ld, as the stripe kernels' tiles), rows at or past R zero-filled.
//
// A block walks a contiguous range of work units (a unit: one pair, or one
// pair and a tile of its rows), so the mask rows it stages in shared memory
// serve every unit of the same mask class and are staged again only when the
// class changes (on the sharded path Gm = 1: once per block).
#pragma once

#include "stripe_tiles.cuh"

namespace nmrf {

struct MaskedParams {
  int G, Gm, heads, Rq, Rk;
  float scale;
};

constexpr float kLog2e = 1.4426950408889634f;

// 4 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// rows r0..r0+rows-1 of a dense [R, HD] slice x into a [rows, HD + 8] tile;
// rows at or past R are zero-filled
template <int HD>
__device__ __forceinline__ void stage_dense(__nv_bfloat16* d, const __nv_bfloat16* x, int r0,
                                            int rows, int R) {
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  constexpr int LD = mma_ld<HD>();
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx % CH;
    const bool valid = r0 + r < R;
    cp_async16(d + r * LD + c * 8, x + (valid ? static_cast<long long>(r0 + r) * HD + c * 8 : 0),
               valid);
  }
}

// rows r0..r0+rows-1, columns c0..c0+cols-1 (cols a multiple of 4) of one
// group class's [Rq, Rk] mask m into a [rows, ld] f32 block; entries past Rq
// or Rk are zero-filled.  16-byte copies where every row starts on a 16-byte
// boundary (Rk and c0 multiples of 4), 4-byte copies otherwise.
__device__ __forceinline__ void stage_mask(float* d, int ld, const float* m, int Rq, int Rk,
                                           int r0, int rows, int c0, int cols) {
  if ((Rk & 3) == 0 && (c0 & 3) == 0) {
    const int ch = cols / 4;
    for (int idx = threadIdx.x; idx < rows * ch; idx += blockDim.x) {
      const int r = idx / ch, c = c0 + (idx % ch) * 4;
      const bool valid = r0 + r < Rq && c < Rk;  // Rk % 4 == 0: all 4 or none
      cp_async16(d + r * ld + c - c0,
                 m + (valid ? static_cast<long long>(r0 + r) * Rk + c : 0), valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
      const int r = idx / cols, c = c0 + idx % cols;
      const bool valid = r0 + r < Rq && c < Rk;
      cp_async4(d + r * ld + c - c0, m + (valid ? static_cast<long long>(r0 + r) * Rk + c : 0),
                valid);
    }
  }
}

// [first, last) of the units this block walks: contiguous ranges whose
// sizes differ by at most 1
__device__ __forceinline__ void unit_range(int units, int& first, int& last) {
  first = static_cast<int>(static_cast<long long>(blockIdx.x) * units / gridDim.x);
  last = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * units / gridDim.x);
}

// query rows a query-side block owns: Rq rounded up to 16 rows per warp, at
// most 8 warps (128 rows); one tile when Rq <= 128
inline int masked_q_rows(int Rq) { return Rq >= 128 ? 128 : (Rq + 15) / 16 * 16; }

// f32 row stride of a staged query-side mask block of Rk columns: congruent
// to 8 (mod 16) words, so the 8-byte reads at the C fragment's positions
// (4 rows of 4 lanes a half-warp) fall in distinct banks
inline int masked_mask_ld(int Rk) { return (Rk + 15) / 16 * 16 + 8; }

// f32 row stride of the key side's transposed strip of 64 key columns: 2 ld
// is 8 (mod 32) words, so the reads at mask[i][j] (4 query rows i = 2 t4 of
// a lane quad, 8 key columns j = gq) fall in distinct banks
constexpr int kMaskStripLd = kMmaRows + 4;

}  // namespace nmrf
