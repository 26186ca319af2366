// Shared helpers for the port's hand-written kernels (built with nvcc for
// sm_90a into plain-C shared libraries, loaded with ctypes).
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nmrf {

constexpr float kNegInf = -1e9f;  // finite -inf stand-in of the JAX package

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// one 16-byte vector of channels (4 f32 or 8 bf16), to and from f32
__device__ __forceinline__ void load_vec16(const float* src, float* dst) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void load_vec16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    dst[2 * k] = f.x;
    dst[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}
__device__ __forceinline__ void store_vec16(__nv_bfloat16* dst, const float* src) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(src[2 * k], src[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
enum DType { kF32 = 0, kBF16 = 1 };

// shared memory attributes of a kernel taking smem dynamic bytes, and the
// blocks of its grid over `units`: as many as run at once on the card
template <typename Kernel>
inline cudaError_t launch_config(Kernel kernel, int threads, int smem, int units, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = units < per_sm * sms ? units : per_sm * sms;
  return cudaSuccess;
}

}  // namespace nmrf
