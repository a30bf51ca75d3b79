// causal_conv_silu — Mamba2's depthwise causal convolution with its bias and
// SiLU in one pass:
//     y[b, t, c] = silu(bias[c] + sum_k w[k, c] * x[b, t - (K-1) + k, c]),
// x zero before t = 0, float32 accumulation, y in x's dtype.
//
// Replaces no TPU kernel: the reference writes the convolution as K static
// shifts (models/ssm.py:_causal_conv) and XLA fuses them with the SiLU into
// one loop. Eager PyTorch runs the same shifts as 15 device passes a
// convolution (pad, slice, multiply, add, each writing a full tensor), so the
// port fuses them by hand.
//
// Bound by bytes: each element is read once and written once (4 B in bf16)
// against K multiply-adds and a SiLU. Design for Hopper: each thread owns 8
// consecutive channels (one 16-byte vector of bf16, two of float32) and walks
// a strip of rows of one batch row, keeping the last K-1 rows in float32
// registers, so that every input byte crosses HBM once plus a (K-1)-row halo a
// strip (re-read from L1/L2). The 8 channels' K weights and bias sit in
// float32 registers; UNROLL rows are loaded together (four to eight 16-byte
// loads in flight a thread) before any is used. A block is bx channel vectors
// by by strips; the grid is (channel vectors, strips, B). The launcher picks
// the longest strip (64 rows down to UNROLL) that still gives the card about
// MIN_THREADS threads, so that both zamba2-7b's 7168 channels and its
// 128-channel B / C projections at S = 949 fill the 132 SMs. A ragged S (S <
// K included) is masked here: rows past S are neither read nor written.
// x and w may each be float32 or bfloat16 (w and bias share one dtype), read
// in their own dtype and widened exactly, as rmsnorm.cu reads its weight.
#include "common.cuh"

namespace {

constexpr int CH = 8;               // channels a thread
constexpr int THREADS = 256;        // threads a block
constexpr int UNROLL = 4;           // rows loaded before any is used
constexpr int MAX_STRIP = 64;       // rows a thread at most
constexpr long MIN_THREADS = 132L * 1024;

// CH consecutive values of one row as 16-byte vectors, and back
template <typename T> struct Pack;
template <> struct Pack<float> {
    static constexpr int V = 2;
    static __device__ __forceinline__ void unpack(const uint4* u, float* f) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
            f[4 * i] = __uint_as_float(u[i].x);
            f[4 * i + 1] = __uint_as_float(u[i].y);
            f[4 * i + 2] = __uint_as_float(u[i].z);
            f[4 * i + 3] = __uint_as_float(u[i].w);
        }
    }
    static __device__ __forceinline__ void pack(const float* f, uint4* u) {
#pragma unroll
        for (int i = 0; i < V; ++i)
            u[i] = make_uint4(__float_as_uint(f[4 * i]),
                              __float_as_uint(f[4 * i + 1]),
                              __float_as_uint(f[4 * i + 2]),
                              __float_as_uint(f[4 * i + 3]));
    }
};
template <> struct Pack<__nv_bfloat16> {
    static constexpr int V = 1;
    static __device__ __forceinline__ void unpack(const uint4* u, float* f) {
        const uint32_t w[4] = {u->x, u->y, u->z, u->w};
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
    static __device__ __forceinline__ void pack(const float* f, uint4* u) {
        *u = make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                        pair(f[6], f[7]));
    }
};

template <typename T>
__device__ __forceinline__ void load(const T* p, uint4* u) {
#pragma unroll
    for (int i = 0; i < Pack<T>::V; ++i)
        u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}

template <typename T>
__device__ __forceinline__ void load_f32(const T* p, float* f) {
    uint4 u[Pack<T>::V];
    load(p, u);
    Pack<T>::unpack(u, f);
}

template <typename T, typename W, int K>
__global__ void __launch_bounds__(THREADS)
causal_conv_silu_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        const W* __restrict__ bias, T* __restrict__ y, int S,
                        int C, int strip) {
    constexpr int V = Pack<T>::V;
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    const int t0 = (blockIdx.y * blockDim.y + threadIdx.y) * strip;
    if (v >= C / CH || t0 >= S) return;
    const int t1 = min(S, t0 + strip);
    const size_t at = static_cast<size_t>(blockIdx.z) * S * C + v * CH;
    const T* xb = x + at;
    T* yb = y + at;

    float wk[K][CH], bv[CH];
#pragma unroll
    for (int k = 0; k < K; ++k)
        load_f32(w + static_cast<size_t>(k) * C + v * CH, wk[k]);
    load_f32(bias + v * CH, bv);

    // rows t - (K-1) .. t - 1 of the row being computed; zero before t = 0
    float win[K - 1][CH];
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
        const int t = t0 - (K - 1) + j;
        if (t >= 0) {
            load_f32(xb + static_cast<size_t>(t) * C, win[j]);
        } else {
#pragma unroll
            for (int e = 0; e < CH; ++e) win[j][e] = 0.0f;
        }
    }

    for (int t = t0; t < t1; t += UNROLL) {
        uint4 raw[UNROLL][V];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (t + u < t1) {
                load(xb + static_cast<size_t>(t + u) * C, raw[u]);
            } else {
#pragma unroll
                for (int i = 0; i < V; ++i) raw[u][i] = make_uint4(0, 0, 0, 0);
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            float cur[CH], out[CH];
            Pack<T>::unpack(raw[u], cur);
#pragma unroll
            for (int e = 0; e < CH; ++e) {
                // the composite's order: the current row, the oldest to the
                // newest shifted row, then the bias
                float acc = cur[e] * wk[K - 1][e];
#pragma unroll
                for (int k = 0; k < K - 1; ++k)
                    acc = fmaf(win[k][e], wk[k][e], acc);
                acc += bv[e];
                out[e] = __fdividef(acc, 1.0f + __expf(-acc));
            }
            if (t + u < t1) {
                uint4 o[V];
                Pack<T>::pack(out, o);
#pragma unroll
                for (int i = 0; i < V; ++i)
                    reinterpret_cast<uint4*>(
                        yb + static_cast<size_t>(t + u) * C)[i] = o[i];
            }
            // past t1 the window takes zeros, and the loop ends
#pragma unroll
            for (int j = 0; j < K - 2; ++j)
#pragma unroll
                for (int e = 0; e < CH; ++e) win[j][e] = win[j + 1][e];
#pragma unroll
            for (int e = 0; e < CH; ++e) win[K - 2][e] = cur[e];
        }
    }
}

unsigned next_pow2(unsigned n) {
    unsigned p = 1;
    while (p < n) p <<= 1;
    return p;
}

template <typename T, typename W, int K>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int B, int S, int C, cudaStream_t st) {
    const int nv = C / CH;
    int strip = MAX_STRIP;
    while (strip > UNROLL && static_cast<long>(nv) * B
           * ((S + strip - 1) / strip) < MIN_THREADS)
        strip /= 2;
    const int strips = (S + strip - 1) / strip;
    const unsigned bx = next_pow2(nv) < 128 ? next_pow2(nv) : 128;
    const unsigned by = THREADS / bx;
    const dim3 grid((nv + bx - 1) / bx, (strips + by - 1) / by, B);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    causal_conv_silu_kernel<T, W, K><<<grid, dim3(bx, by), 0, st>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<const W*>(b), static_cast<T*>(y), S, C, strip);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_x(const void* x, const void* w, const void* b, void* y,
                     int B, int S, int C, int w_dtype, cudaStream_t st) {
    if (w_dtype == DTYPE_F32)
        return launch<T, float, 4>(x, w, b, y, B, S, C, st);
    if (w_dtype == DTYPE_BF16)
        return launch<T, __nv_bfloat16, 4>(x, w, b, y, B, S, C, st);
    return cudaErrorInvalidValue;
}

}  // namespace

// x, y: [B, S, C] contiguous, dtype `x_dtype`; w: [K, C] and b: [C]
// contiguous, dtype `w_dtype` (each DTYPE_F32 or DTYPE_BF16); C a multiple of
// 8; K = 4 (the one width instantiated); every pointer 16-byte aligned.
// Launches on `stream`, never synchronises; returns the launch's cudaError_t
// (0 on success).
REPRO_EXPORT int causal_conv_silu_launch(const void* x, const void* w,
                                         const void* b, void* y, int B, int S,
                                         int C, int K, int x_dtype,
                                         int w_dtype, void* stream) {
    if (B <= 0 || S <= 0 || C <= 0 || C % CH || K != 4)
        return static_cast<int>(cudaErrorInvalidValue);
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)
         | reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(y))
        & 15)
        return static_cast<int>(cudaErrorMisalignedAddress);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (x_dtype == DTYPE_F32)
        err = launch_x<float>(x, w, b, y, B, S, C, w_dtype, st);
    else if (x_dtype == DTYPE_BF16)
        err = launch_x<__nv_bfloat16>(x, w, b, y, B, S, C, w_dtype, st);
    return static_cast<int>(err);
}

REPRO_EXPORT const char* causal_conv_silu_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
