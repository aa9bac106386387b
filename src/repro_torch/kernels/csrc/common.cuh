// Helpers shared by the kernel sources: per-device launch state, and the
// conversions of a bf16 stream to and from the float its kernels compute in.
//
// A CUDA function attribute such as the dynamic shared-memory opt-in is set
// per device, and a process may launch on several cards; so every cache of
// a per-device value is a table indexed by the device ordinal, never one
// static value set on whatever device was current at the first call.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace repro {

// an element widened to float (exact for bf16), and a float rounded to the
// element type (to nearest even for bf16: one rounding, as the reference's
// astype)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

constexpr int MAX_DEVICES = 64;          // devices past this are not cached
constexpr size_t DEFAULT_SMEM = 48 * 1024;  // dynamic shared memory without opt-in

// The dynamic shared-memory opt-in of one kernel, kept per device: a launch
// site holds one `static SmemOptIn` per kernel it launches and calls
// ensure() with the bytes of each launch.
class SmemOptIn {
  public:
    cudaError_t ensure(const void* kernel, size_t bytes) {
        if (bytes <= DEFAULT_SMEM) return cudaSuccess;
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        const bool cached = dev >= 0 && dev < MAX_DEVICES;
        if (cached && bytes <= opted_[dev]) return cudaSuccess;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
        if (err == cudaSuccess && cached) opted_[dev] = bytes;
        return err;
    }

  private:
    size_t opted_[MAX_DEVICES] = {};
};

// The current device's SM count (an attribute query: cheap, no cache)
inline cudaError_t sm_count(int* count) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    return cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace repro
