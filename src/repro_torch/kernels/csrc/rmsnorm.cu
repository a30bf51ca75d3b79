// rmsnorm — y = x * rsqrt(mean(x^2) + eps) * w over the last axis, with
// float32 statistics and the output in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:_rmsnorm_kernel (a
// Pallas grid over 128-row blocks, the whole feature dim resident in VMEM).
//
// Bound by bytes: each element is read once and written once (4 B per
// element in bf16, 8 B in f32) against four float operations.  Design for
// Hopper: one warp per row, ROW_WARPS rows per block.  Each lane loads its
// share of the row as 16-byte vectors (8 bf16 or 4 f32) and keeps them in
// registers; the warp reduces the sum of squares with shuffles only (no
// shared memory, no __syncthreads); the lane then scales the registers it
// holds by inv and by the weight (16-byte loads, L1/L2-resident across
// rows, issued with x's loads where they fit in 64 registers so that their
// latency hides behind the reduction) and writes 16-byte vectors.
// Any d: x, y and w start 16-byte aligned (the launcher's contract), so a
// row whose start is not aligned
// (d * sizeof(x) not a multiple of 16) has a scalar head up to the next
// aligned address, then vectors, then a scalar tail of fewer than one
// vector; where that head leaves w's share unaligned, w is read as scalars.
// Rows too long for a warp's registers (over 16 vectors a lane: d > 4096 in
// bf16, > 2048 in f32) take a block-per-row kernel that strides over the
// row and re-reads it — a dispatch on d.  x and w may each be float32 or
// bfloat16 and are widened to float32 (the reference's astype(float32)), so
// a model's bf16 weight is read as it is stored, with no cast launched
// before the kernel; widening is exact, so both weight types give the same
// bits.
// 1/sqrt is IEEE-rounded rather than the approximate rsqrtf so float32 rows
// match the plain version to ~1 ulp.
// With `groups` > 1 the weight holds `groups` rows of d and row r of x is
// scaled by part r % groups: a [.., groups * d] tensor viewed as rows of d
// is normalised group by group (Mamba2's grouped gate norm) in the same
// launch.
#include "common.cuh"
#include <math.h>

namespace {

constexpr int MAX_D = 65536;
constexpr int ROW_WARPS = 8;          // rows per block, one warp each
constexpr int MAX_NV = 16;            // 16-byte vectors a lane keeps at most
constexpr int LONG_THREADS = 512;     // threads per row above that

// a 16-byte vector of x's type as VEC floats, and back
template <typename T> struct Vec;
template <> struct Vec<float> {
    static constexpr int N = 4;
    static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
        f[0] = __uint_as_float(u.x);
        f[1] = __uint_as_float(u.y);
        f[2] = __uint_as_float(u.z);
        f[3] = __uint_as_float(u.w);
    }
    static __device__ __forceinline__ uint4 pack(const float* f) {
        return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                          __float_as_uint(f[2]), __float_as_uint(f[3]));
    }
};
template <> struct Vec<__nv_bfloat16> {
    static constexpr int N = 8;
    static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {           // low half is the first value
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
    static __device__ __forceinline__ uint32_t pair(float lo, float hi) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<const uint32_t*>(&v);
    }
    static __device__ __forceinline__ uint4 pack(const float* f) {
        return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]),
                          pair(f[4], f[5]), pair(f[6], f[7]));
    }
};

// w[c .. c + N) as floats: 16-byte loads (one 8-byte load for four bf16
// weights) where w + c is aligned to them, else scalars
template <typename W, int N>
__device__ __forceinline__ void load_w(const W* __restrict__ w, int c,
                                       bool vec, float* wv) {
    constexpr int PER = Vec<W>::N;           // weights a 16-byte load
    if (!vec) {
#pragma unroll
        for (int e = 0; e < N; ++e) wv[e] = to_f32(w[c + e]);
    } else if constexpr (N >= PER) {
#pragma unroll
        for (int q = 0; q < N / PER; ++q)
            Vec<W>::unpack(__ldg(reinterpret_cast<const uint4*>(w + c) + q),
                           wv + q * PER);
    } else {                                 // four bf16 weights of f32 x
        static_assert(N == 4 && PER == 8, "four bf16 weights");
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(w + c));
        wv[0] = __uint_as_float(t.x << 16);
        wv[1] = __uint_as_float(t.x & 0xffff0000u);
        wv[2] = __uint_as_float(t.y << 16);
        wv[3] = __uint_as_float(t.y & 0xffff0000u);
    }
}

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(ROW_WARPS * 32)
rmsnorm_rows(const T* __restrict__ x, const W* __restrict__ w,
             T* __restrict__ y, int rows, int d, float eps, int groups) {
    constexpr int VEC = Vec<T>::N;
    const int lane = threadIdx.x & 31;
    const size_t row = static_cast<size_t>(blockIdx.x) * ROW_WARPS
                       + (threadIdx.x >> 5);
    if (row >= static_cast<size_t>(rows)) return;
    const size_t off = row * d;
    w += static_cast<size_t>(row % groups) * d;
    const T* xr = x + off;
    T* yr = y + off;
    // the row starts off % VEC elements past a 16-byte boundary
    const int mis = static_cast<int>(off % VEC);
    const int head = mis ? min(d, VEC - mis) : 0;
    const int nvec = (d - head) / VEC;
    const int tail_at = head + nvec * VEC;
    const int tail = d - tail_at;

    // w + head is aligned to w's loads of one x vector's share
    constexpr int W_LOAD = VEC * sizeof(W) < 16 ? VEC * sizeof(W) : 16;
    const bool w_vec = head * sizeof(W) % W_LOAD == 0;
    // w's share kept in registers from the start where it fits in 64
    constexpr bool KEEP_W = NV * VEC <= 64;
    float wk[KEEP_W ? NV * VEC : 1];

    // one pass over x: head / tail scalars (lane < VEC) and NV vectors
    const float hv = lane < head ? to_f32(xr[lane]) : 0.0f;
    const float tv = lane < tail ? to_f32(xr[tail_at + lane]) : 0.0f;
    float ss = fmaf(hv, hv, tv * tv);
    uint4 buf[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        const int v = lane + 32 * i;
        if (v < nvec) {
            buf[i] = *reinterpret_cast<const uint4*>(xr + head + v * VEC);
            if constexpr (KEEP_W)
                load_w<W, VEC>(w, head + v * VEC, w_vec, wk + i * VEC);
            float f[VEC];
            Vec<T>::unpack(buf[i], f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) ss = fmaf(f[e], f[e], ss);
        }
    }
    // butterfly: every lane ends with the same total, bit for bit
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL_WARP, ss, o);
    const float inv = 1.0f / sqrtf(ss / d + eps);

    if (lane < head) yr[lane] = from_f32<T>(hv * inv * to_f32(w[lane]));
    if (lane < tail)
        yr[tail_at + lane] =
            from_f32<T>(tv * inv * to_f32(w[tail_at + lane]));
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        const int v = lane + 32 * i;
        if (v < nvec) {
            const int c = head + v * VEC;
            float f[VEC], wv[VEC];
            Vec<T>::unpack(buf[i], f);
            if constexpr (KEEP_W) {
#pragma unroll
                for (int e = 0; e < VEC; ++e) wv[e] = wk[i * VEC + e];
            } else {
                load_w<W, VEC>(w, c, w_vec, wv);
            }
#pragma unroll
            for (int e = 0; e < VEC; ++e) f[e] = f[e] * inv * wv[e];
            *reinterpret_cast<uint4*>(yr + c) = Vec<T>::pack(f);
        }
    }
}

template <typename T, typename W>
__global__ void __launch_bounds__(LONG_THREADS)
rmsnorm_long(const T* __restrict__ x, const W* __restrict__ w,
             T* __restrict__ y, int d, float eps, int groups) {
    __shared__ float s_part[LONG_THREADS / 32];
    const size_t off = static_cast<size_t>(blockIdx.x) * d;
    w += static_cast<size_t>(blockIdx.x % groups) * d;
    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += LONG_THREADS) {
        const float v = to_f32(x[off + i]);
        ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL_WARP, ss, o);
    if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = ss;
    __syncthreads();
    float total = 0.0f;                       // same order in every thread
    for (int k = 0; k < LONG_THREADS / 32; ++k) total += s_part[k];
    const float inv = 1.0f / sqrtf(total / d + eps);
    for (int i = threadIdx.x; i < d; i += LONG_THREADS)
        y[off + i] =
            from_f32<T>(to_f32(x[off + i]) * inv * to_f32(w[i]));
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, int groups, cudaStream_t st) {
    const T* xp = static_cast<const T*>(x);
    const W* wp = static_cast<const W*>(w);
    T* yp = static_cast<T*>(y);
    const int per_lane = (d + 32 * Vec<T>::N - 1) / (32 * Vec<T>::N);
    const int blocks = (rows + ROW_WARPS - 1) / ROW_WARPS;
    constexpr int threads = ROW_WARPS * 32;
    if (per_lane <= 1)
        rmsnorm_rows<T, W, 1><<<blocks, threads, 0, st>>>(xp, wp, yp, rows,
                                                          d, eps, groups);
    else if (per_lane <= 2)
        rmsnorm_rows<T, W, 2><<<blocks, threads, 0, st>>>(xp, wp, yp, rows,
                                                          d, eps, groups);
    else if (per_lane <= 4)
        rmsnorm_rows<T, W, 4><<<blocks, threads, 0, st>>>(xp, wp, yp, rows,
                                                          d, eps, groups);
    else if (per_lane <= 8)
        rmsnorm_rows<T, W, 8><<<blocks, threads, 0, st>>>(xp, wp, yp, rows,
                                                          d, eps, groups);
    else if (per_lane <= MAX_NV)
        rmsnorm_rows<T, W, MAX_NV><<<blocks, threads, 0, st>>>(xp, wp, yp,
                                                               rows, d, eps,
                                                               groups);
    else
        rmsnorm_long<T, W><<<rows, LONG_THREADS, 0, st>>>(xp, wp, yp, d, eps,
                                                         groups);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_x(const void* x, const void* w, void* y, int rows, int d,
                     float eps, int w_dtype, int groups, cudaStream_t st) {
    if (w_dtype == DTYPE_F32)
        return launch<T, float>(x, w, y, rows, d, eps, groups, st);
    if (w_dtype == DTYPE_BF16)
        return launch<T, __nv_bfloat16>(x, w, y, rows, d, eps, groups, st);
    return cudaErrorInvalidValue;
}

}  // namespace

// x, y: [rows, d] contiguous, dtype `x_dtype`; w: [groups * d] contiguous,
// dtype `w_dtype` (each DTYPE_F32 or DTYPE_BF16), row r scaled by part
// r % groups; x, w and y 16-byte aligned, and each part of w too where
// groups > 1.  Launches on `stream`, never synchronises; returns the
// launch's cudaError_t (0 on success).
REPRO_EXPORT int rmsnorm_launch(const void* x, const void* w, void* y,
                                int rows, int d, float eps, int x_dtype,
                                int w_dtype, int groups, void* stream) {
    if (rows <= 0 || d <= 0 || d > MAX_D || groups < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (groups > 1 && d * (w_dtype == DTYPE_F32 ? 4 : 2) % 16)
        return static_cast<int>(cudaErrorMisalignedAddress);
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)
         | reinterpret_cast<uintptr_t>(y)) & 15)
        return static_cast<int>(cudaErrorMisalignedAddress);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (x_dtype == DTYPE_F32)
        err = launch_x<float>(x, w, y, rows, d, eps, w_dtype, groups, st);
    else if (x_dtype == DTYPE_BF16)
        err = launch_x<__nv_bfloat16>(x, w, y, rows, d, eps, w_dtype, groups,
                                      st);
    return static_cast<int>(err);
}

REPRO_EXPORT const char* rmsnorm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
