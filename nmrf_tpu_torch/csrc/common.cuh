// Shared helpers for the port's hand-written kernels (built with nvcc for
// sm_90a into plain-C shared libraries, loaded with ctypes).
#pragma once

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
