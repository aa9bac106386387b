// Shared C entry points of the kernel library.

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The limits the launch plans of kernels/hw_scan.py and kernels/lstm_cell.py
// are made for: device `dev`'s SM count and the dynamic shared memory one
// block may opt in to (232,448 bytes on an H100)
extern "C" int repro_device_limits(int dev, int* sm_count, int* smem_optin) {
    cudaError_t err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return static_cast<int>(err);
}
