// rmsnorm — y = x * rsqrt(mean(x^2) + eps) * w over the last axis, with
// float32 statistics and the output in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:_rmsnorm_kernel (a
// Pallas grid over 128-row blocks, the whole feature dim resident in VMEM).
//
// Design for Hopper: one thread block per row, threads strided over the d
// features with a bounds check (any d up to MAX_D; no padding), the sum of
// squares reduced by warp shuffles and one shared-memory pass.  The row is
// read twice — the second read hits L1/L2 — and written once, so the kernel
// is bound by bytes (each element read and written once from device memory:
// 4 B per element in bf16, 8 B in f32, against four float operations).
// x may be float32 or bfloat16 and is widened to float32 (the reference's
// astype(float32)); w is float32.  1/sqrt is IEEE-rounded rather than the
// approximate rsqrtf so float32 rows match the plain version to ~1 ulp.
#include "common.cuh"
#include <math.h>

namespace {

constexpr int MAX_D = 65536;

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ w, T* __restrict__ y,
                               int d, float eps) {
    __shared__ float s_part[MAX_WARPS];
    const size_t row = static_cast<size_t>(blockIdx.x) * d;

    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
        const float v = to_f32(x[row + i]);
        ss = fmaf(v, v, ss);
    }
    for (int off = 16; off > 0; off >>= 1)
        ss += __shfl_down_sync(FULL_WARP, ss, off);
    if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = ss;
    __syncthreads();
    float total = 0.0f;
    const int n_warps = (blockDim.x + 31) >> 5;
    for (int k = 0; k < n_warps; ++k) total += s_part[k];   // same order in
    const float inv = 1.0f / sqrtf(total / d + eps);        // every thread

    for (int i = threadIdx.x; i < d; i += blockDim.x) {
        const float v = to_f32(x[row + i]) * inv;
        y[row + i] = from_f32<T>(v * w[i]);
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, cudaStream_t st) {
    // one warp per 32 features up to 256 threads; wider rows stride
    int threads = ((d + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    rmsnorm_kernel<T><<<rows, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<T*>(y), d, eps);
    return cudaGetLastError();
}

}  // namespace

// x, y: [rows, d] contiguous, dtype `x_dtype` (DTYPE_F32 or DTYPE_BF16);
// w: [d] contiguous float32.  Launches on `stream`, never synchronises;
// returns the launch's cudaError_t (0 on success).
REPRO_EXPORT int rmsnorm_launch(const void* x, const void* w, void* y,
                                int rows, int d, float eps, int x_dtype,
                                void* stream) {
    if (rows <= 0 || d <= 0 || d > MAX_D)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (x_dtype == DTYPE_F32)
        err = launch<float>(x, w, y, rows, d, eps, st);
    else if (x_dtype == DTYPE_BF16)
        err = launch<__nv_bfloat16>(x, w, y, rows, d, eps, st);
    return static_cast<int>(err);
}

REPRO_EXPORT const char* rmsnorm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
