// Shared helpers for the port's hand-written kernels (built with nvcc for
// sm_90a into plain-C shared libraries, loaded with ctypes).
#pragma once

#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

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

// the most shared memory a block may opt into on sm_90a (227 KB), the only
// target the port is built for
constexpr size_t kMaxBlockSmem = 232448;

// Launch set-up, the one place the kernels call the runtime before a launch.
// What it sets or asks is cached by kernel instantiation and current device
// (function attributes belong to a device's context), so after the first
// launch of a kernel at a shared-memory size a launch makes no call but
// cudaGetDevice.  ctypes releases the GIL around an entry point, so two host
// threads can be in here at once: one mutex guards the caches.
namespace setup {
inline std::mutex mutex;
// (kernel, device) -> the dynamic shared memory its attribute was set to
inline std::map<std::pair<const void*, int>, int> smem_set;
// (kernel, device, threads, smem) -> the blocks of it that run at once
inline std::map<std::tuple<const void*, int, int, int>, int> resident;

// under the mutex: set fn's dynamic shared memory attribute to smem unless
// it was set to at least that on dev (attributes only grow)
inline cudaError_t grow_smem(const void* fn, int dev, int smem) {
  const auto it = smem_set.find({fn, dev});
  if (it != smem_set.end() && it->second >= smem) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) smem_set[{fn, dev}] = smem;
  return err;
}
}  // namespace setup

// let kernel take smem bytes of dynamic shared memory on the current device
template <typename Kernel>
inline cudaError_t ensure_smem(Kernel kernel, size_t smem) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(setup::mutex);
  return setup::grow_smem(reinterpret_cast<const void*>(kernel), dev, static_cast<int>(smem));
}

// ensure_smem, the carveout that prefers shared memory, and the blocks of a
// grid over `units`: as many as run at once on the card
template <typename Kernel>
inline cudaError_t launch_config(Kernel kernel, int threads, int smem, int units, int* blocks) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(setup::mutex);
  err = setup::grow_smem(fn, dev, smem);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(fn, dev, threads, smem);
  auto it = setup::resident.find(key);
  if (it == setup::resident.end()) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    it = setup::resident.emplace(key, per_sm * sms).first;
  }
  *blocks = units < it->second ? units : it->second;
  return cudaSuccess;
}

}  // namespace nmrf
