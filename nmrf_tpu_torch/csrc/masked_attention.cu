// Rectangular masked attention (B6).
//
// Replaces nmrf_tpu/ops/pallas/attention.py:_masked_attention_kernel, driven
// by masked_attention / masked_attention_op.
//
// Function, per group g and head h, for Rq query rows and Rk key rows:
//   out_i = sum_j softmax_j(scale q_i.k_j + mask[g % Gm, i, j]) v_j
// with an explicit additive f32 mask (Gm = 1 broadcasts one mask over the
// groups).  Rq differs from Rk on its one path: under H-sharding the CSWin
// vertical stripe spans the global H, so the local query rows of a tile
// attend to the all-gathered stripe (Rq = H8_loc*N, Rk = H8*N).
// Layouts: q [h, G, Rq, hd], k and v [h, G, Rk, hd], mask [Gm, Rq, Rk] f32,
// out [h, G, Rq, hd] in q's dtype.
//
// Bound on the H100 (bf16, Rq 96, Rk 192, 2 heads of 32, the tile-1 mask,
// Gm 1; chip_smoke.py:masked_bound): q, k, v and the mask read and the
// output written once, 11.6 MB at G 156 (a sharded KITTI frame: 3.5 us per
// launch) and 56.9 MB at G 768 (the sharded training step: 17 us), against
// 2 x 2 x Rq x Rk x hd flops per (group, head) (0.7 and 3.7 GFLOP: 0.7 and
// 3.7 us at the bf16 tensor-core rate); the bytes bound it.
//
// bf16 (every launch of the sharded paths): K2's flash-attention forward
// (stripe_attention.cu) on dense rows with the explicit mask.  mma.sync
// m16n8k16 with bf16 operands and f32 accumulation, fed by ldmatrix.  A
// block of Rq/16 warps (at most 8) owns all query rows of a (group, head)
// pair (6 warps at Rq 96, so no warp idles on a ragged second 64-row tile;
// 128-row tiles when Rq > 128).  Key and value rows stream 64 at a time,
// double-buffered with 16-byte cp.async into rows padded to HD + 8
// (masked_tiles.cuh); the q rows are double-buffered by pair, so the next
// pair's loads run under this pair's products.  The block's mask rows
// ([Rq, Rk] f32, 77 KB at the path's shape with its padded stride) are
// staged in shared memory once and serve every pair of the block's
// contiguous range that shares the mask class (row tile, g % Gm): with
// Gm = 1 the mask is read once per block instead of once per pair (147 MB
// of L2 reads per launch at G 768 in the CUDA-core version, against 57 MB of
// q, k, v and out).  Where the staged rows do not fit in a block's shared
// memory they are read from device memory at the fragments' positions.
// Per 16-key chunk: S = Q K^T, the logits scale * S + mask in log2 units
// (the mask read at the C fragment's positions; -inf past Rk; a key masked
// with -1e9 stays in the sum, so a row masked everywhere gives the uniform
// softmax of the plain version), the running max and sum in f32 with quad
// shuffles, and P, rounded to bf16, reused as the A fragment of O += P V
// with V by ldmatrix.trans.  One normalisation at the end; each output row
// is written once.  At Rq 96, Rk 192 a block takes 113 KB of shared memory,
// so two blocks (12 warps) share an SM.  Expected above the bound: the
// per-pair chain of three key tiles (load, two products, softmax) with 12
// warps an SM to hide it, and at G 156 (312 pairs, 264 blocks) the mask
// staging once per block for about one pair.
//
// f32 (phase 2 and phase 7's f32 checks at 1e-4, which TF32 would not
// meet): the CUDA-core version, one block of 64 threads per (64-query tile,
// group, head), one query row per thread with its scaled q and the output
// accumulator in registers; key and value rows stream through shared memory
// 32 at a time with the [64 x 32] tile of the mask beside them; an online
// softmax in f32.

#include "common.cuh"
#include "masked_tiles.cuh"

namespace nmrf {

constexpr int kMaQTile = 64;
constexpr int kMaKTile = 32;

template <typename T, int HD>
__global__ void __launch_bounds__(kMaQTile)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ mask,
                        T* __restrict__ out, MaskedParams p) {
  __shared__ float sk[kMaKTile][HD + 1];
  __shared__ float sv[kMaKTile][HD + 1];
  __shared__ float sm[kMaQTile][kMaKTile + 1];
  const int g = blockIdx.y, head = blockIdx.z;
  const int q0 = blockIdx.x * kMaQTile;
  const int i = q0 + threadIdx.x;
  const bool active = i < p.Rq;
  const long long gh = static_cast<long long>(head) * p.G + g;
  const T* qb = q + gh * p.Rq * HD;
  const T* kb = k + gh * p.Rk * HD;
  const T* vb = v + gh * p.Rk * HD;
  const float* mb = mask + static_cast<long long>(g % p.Gm) * p.Rq * p.Rk;

  float qr[HD], acc[HD];
  if (active) {
#pragma unroll
    for (int c = 0; c < HD; ++c) qr[c] = to_float(qb[static_cast<long long>(i) * HD + c]) * p.scale;
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < p.Rk; j0 += kMaKTile) {
    const int nk = min(kMaKTile, p.Rk - j0);
    for (int idx = threadIdx.x; idx < nk * HD; idx += kMaQTile) {
      const int jj = idx / HD, c = idx % HD;
      const long long off = static_cast<long long>(j0 + jj) * HD + c;
      sk[jj][c] = to_float(kb[off]);
      sv[jj][c] = to_float(vb[off]);
    }
    for (int idx = threadIdx.x; idx < kMaQTile * kMaKTile; idx += kMaQTile) {
      const int ii = idx / kMaKTile, jj = idx % kMaKTile;
      sm[ii][jj] = (q0 + ii < p.Rq && jj < nk)
                       ? mb[static_cast<long long>(q0 + ii) * p.Rk + j0 + jj]
                       : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int jj = 0; jj < nk; ++jj) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) s += qr[c] * sk[jj][c];
        s += sm[threadIdx.x][jj];
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
  if (active) {
    T* o = out + (gh * p.Rq + i) * HD;
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] = from_float<T>(acc[c] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// how a launch cuts its work: units (row tile, group, head), u = (qt G + g)
// heads + head, each a tile of q_rows query rows of one pair
struct MaskedFwdTiling {
  int q_rows, units, mask_ld;
  int resident;  // the block's mask rows are staged in shared memory
};

// bytes of shared memory: q tiles (two), k and v tiles (two each), and the
// staged mask rows when resident
template <int HD>
inline size_t masked_fwd_smem_bytes(const MaskedFwdTiling& t, bool resident) {
  return (static_cast<size_t>(2) * t.q_rows + 4 * kMmaRows) * mma_ld<HD>() * sizeof(bf16) +
         (resident ? static_cast<size_t>(t.q_rows) * t.mask_ld * sizeof(float) : 0);
}

template <int HD>
__global__ void __launch_bounds__(256)
masked_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ mask,
                            bf16* __restrict__ out, MaskedParams p, MaskedFwdTiling t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = mma_ld<HD>(), KS = HD / 16, NTD = HD / 8, KTILE = kMmaRows * LD;
  const int QTILE = t.q_rows * LD;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [2][QTILE]
  bf16* sK = sQ + 2 * QTILE;                     // [2][KTILE]
  bf16* sV = sK + 2 * KTILE;                     // [2][KTILE]
  float* sM = reinterpret_cast<float*>(sV + 2 * KTILE);  // [q_rows, mask_ld] if resident
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t4 = lane & 3;
  const int nkt = (p.Rk + kMmaRows - 1) / kMmaRows;
  // logits in log2 units, so that exp2 takes the place of exp
  const float sl2 = p.scale * kLog2e;
  int u0, u1;
  unit_range(t.units, u0, u1);
  const int nitems = (u1 - u0) * nkt;  // (unit, key tile), key tiles fastest

  // q rows of the unit's tile with its first key tile; k and v rows of a
  // key tile
  auto stage = [&](int item) {
    const int u = u0 + item / nkt, kt = item % nkt;
    const int qt = u / (p.G * p.heads), g = (u / p.heads) % p.G, head = u % p.heads;
    const long long gh = static_cast<long long>(head) * p.G + g;
    if (kt == 0)
      stage_dense<HD>(sQ + ((item / nkt) & 1) * QTILE, q + gh * p.Rq * HD, qt * t.q_rows,
                      t.q_rows, p.Rq);
    stage_dense<HD>(sK + (item & 1) * KTILE, k + gh * p.Rk * HD, kt * kMmaRows, kMmaRows, p.Rk);
    stage_dense<HD>(sV + (item & 1) * KTILE, v + gh * p.Rk * HD, kt * kMmaRows, kMmaRows, p.Rk);
  };

  if (nitems > 0) stage(0);
  cp_async_commit();

  int staged = -1;  // mask class (qt, g % Gm) of the rows in sM
  const float* mrow[2] = {nullptr, nullptr};  // device-memory mask rows when not resident
  int qi[2] = {0, 0};
  uint32_t qa[KS][4];
  float m[2], l[2], oa[NTD][4];
  long long gh = 0;

  for (int it = 0; it < nitems; ++it) {
    const int ul = it / nkt, kt = it % nkt;
    const int u = u0 + ul;
    const int qt = u / (p.G * p.heads), g = (u / p.heads) % p.G, head = u % p.heads;
    if (kt == 0) {
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
        l[r] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < NTD; ++n) oa[n][0] = oa[n][1] = oa[n][2] = oa[n][3] = 0.f;
    }
    cp_async_commit();  // the mask rows, if staged: complete at the wait below
    if (it + 1 < nitems) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        load_a(qa[ks], sQ + (ul & 1) * QTILE, LD, warp * 16, ks * 16, lane);
    }
    const bf16* tk = sK + (it & 1) * KTILE;
    const bf16* tv = sV + (it & 1) * KTILE;
    const int j0 = kt * kMmaRows;
    for (int kc = 0; kc < kMmaRows / 16 && j0 + kc * 16 < p.Rk; ++kc) {
      float s[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        load_b_rows(b, tk, LD, kc * 16, ks * 16, lane);
        mma_bf16(s[0], qa[ks], b[0], b[1]);
        mma_bf16(s[1], qa[ks], b[2], b[3]);
      }
      // logits + mask, in log2 units; -inf past Rk
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
          s[nt][2 * r] = j < p.Rk ? fmaf(mv.x, kLog2e, s[nt][2 * r] * sl2) : -INFINITY;
          s[nt][2 * r + 1] = j + 1 < p.Rk ? fmaf(mv.y, kLog2e, s[nt][2 * r + 1] * sl2) : -INFINITY;
        }
      // online softmax: running max and sum; rescale the output rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mx = quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                        fmaxf(s[1][2 * r], s[1][2 * r + 1])));
        const float mn = fmaxf(m[r], mx);
        const float mu = mn == -INFINITY ? 0.f : mn;
        const float corr = exp2f(m[r] - mu);
        l[r] *= corr;
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
          oa[n][2 * r] *= corr;
          oa[n][2 * r + 1] *= corr;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float e = exp2f(s[nt][2 * r + c] - mu);
            s[nt][2 * r + c] = e;
            l[r] += e;
          }
        m[r] = mn;
      }
      // O += P V, P as the A fragment
      uint32_t a[4];
      c_to_a(a, s[0], s[1]);
#pragma unroll
      for (int nd = 0; nd < NTD / 2; ++nd) {
        uint32_t b[4];
        load_b_cols(b, tv, LD, kc * 16, nd * 16, lane);
        mma_bf16(oa[2 * nd], a, b[0], b[1]);
        mma_bf16(oa[2 * nd + 1], a, b[2], b[3]);
      }
    }
    if (kt == nkt - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float inv = 1.f / quad_sum(l[r]);
        if (qi[r] >= p.Rq) continue;
        bf16* dst = out + (gh * p.Rq + qi[r]) * HD + 2 * t4;
#pragma unroll
        for (int n = 0; n < NTD; ++n)
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
              __floats2bfloat162_rn(oa[n][2 * r] * inv, oa[n][2 * r + 1] * inv);
      }
    }
    __syncthreads();
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const float* mask, void* out,
               MaskedParams p, cudaStream_t stream) {
  MaskedFwdTiling t;
  t.q_rows = masked_q_rows(p.Rq);
  t.mask_ld = masked_mask_ld(p.Rk);
  const long long units =
      static_cast<long long>((p.Rq + t.q_rows - 1) / t.q_rows) * p.G * p.heads;
  if (units > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  t.units = static_cast<int>(units);
  t.resident = masked_fwd_smem_bytes<HD>(t, true) <= kMaxBlockSmem;
  const int smem = static_cast<int>(masked_fwd_smem_bytes<HD>(t, t.resident));
  const int threads = t.q_rows / 16 * 32;
  int blocks = 0;
  const cudaError_t err =
      launch_config(masked_attention_mma_kernel<HD>, threads, smem, t.units, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_attention_mma_kernel<HD><<<blocks, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
      static_cast<bf16*>(out), p, t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const float* mask, void* out,
           MaskedParams p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_mma<HD>(q, k, v, mask, out, p, stream);
  } else {
    dim3 grid((p.Rq + kMaQTile - 1) / kMaQTile, p.G, p.heads);
    masked_attention_kernel<T, HD><<<grid, kMaQTile, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        static_cast<T*>(out), p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const float* mask,
                void* out, MaskedParams p, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, mask, out, p, s);
    case 32: return launch<T, 32>(q, k, v, mask, out, p, s);
    case 64: return launch<T, 64>(q, k, v, mask, out, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nmrf

extern "C" int nmrf_masked_attention(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int dtype, int G, int Gm,
                                     int heads, int Rq, int Rk, int hd, float scale,
                                     void* stream) {
  using namespace nmrf;
  if (G <= 0 || Gm <= 0 || heads <= 0 || Rq <= 0 || Rk <= 0 || G > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  MaskedParams p;
  p.G = G; p.Gm = Gm; p.heads = heads; p.Rq = Rq; p.Rk = Rk; p.scale = scale;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_hd<float>(hd, q, k, v, m, out, p, s);
  if (dtype == kBF16) return dispatch_hd<__nv_bfloat16>(hd, q, k, v, m, out, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
