// Helpers shared by the hand-written Hopper kernels of repro_torch.
//
// Every source in this directory is compiled on its own by
// repro_torch/kernels/_build.py into a shared library with a plain C
// interface (no PyTorch headers), so each exports its own launch function
// that returns the cudaError_t of the launch as an int (0 = success).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int MAX_WARPS = 32;          // 1024 threads per block at most

// Element types of the model kernels, as the wrappers pass them
// (repro_torch/kernels/_build.py: DTYPE_CODES).
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// Loads widen to float and stores narrow from float; bf16 stores round to
// nearest even, as torch's .to(torch.bfloat16) and jnp's astype do.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
