// ssd_scan — the Mamba2 SSD chunked scan (arXiv:2405.21060 §6):
// x [b,S,h,p], dt [b,S,h], A [h], B,C [b,S,g,n] -> y [b,S,h,p] and the final
// state [b,h,p,n] (float32).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:_ssd_kernel (grid
// (b*h, chunks) with the chunk axis sequential and the [p, n] float32 state
// carried in VMEM scratch; the whole [l, l] decay matrix resident per step).
//
// Per chunk of length l, with csum = cumsum(dt * A) over the chunk:
//   y_t    = sum_{s<=t} (C_t . B_s) exp(csum_t - csum_s) dt_s x_s      (intra)
//          + exp(csum_t) (C_t . state)                             (carried)
//   state' = exp(csum_l) state + sum_t exp(csum_l - csum_t) dt_t x_t (x) B_t
//
// Design for Hopper: one 256-thread block per (batch, head) loops over the
// chunks in order with the state in shared memory (stored [n][p], 32 KB at
// p = 64, n = 128).  The [l, l] decay-score matrix (256 KB at l = 256) is
// never materialised: the chunk is walked in 64-row tiles of t and, inside
// each, 64-column tiles of s up to the diagonal; a 64 x 64 score tile goes
// through shared memory between the two products.  exp(csum_t - csum_s) is
// evaluated only where t >= s — above the diagonal the exponent is positive
// and can overflow, and the reference selects 0 there.  Any chunk length
// works (mamba2's 300-token prompt runs as one chunk of 300); csum lives in a
// float32 scratch row per (batch, head) that the wrapper allocates.  The
// g -> h group repeat is index arithmetic (head h reads group h / (h/g)),
// never a copy.  All products are float32 FMAs on the CUDA cores (the
// tolerance against the sequential recurrence is 1e-4, so no TF32).  The
// kernel is bound by operations (4.0 GFLOP of float32 at mamba2's B = 4,
// S = 512, bf16 inputs, against 16.9 MB).  Each thread owns a 4 x 4 patch of a score tile
// and of the output tile, and 8 x 4 elements of the state update.
#include "common.cuh"
#include <math.h>

namespace {

constexpr int TT = 64;            // rows t per tile
constexpr int TS = 64;            // columns s per tile
constexpr int PAD = 4;            // keeps float4 rows 16-byte aligned
constexpr int THREADS = 256;      // 16 x 16
constexpr int MAX_P = 64;         // tc + 16 j, j < 4
constexpr int MAX_N = 128;        // a + 16 i, i < 8

// the state block, rounded up so the float4 tiles after it stay aligned
__host__ __device__ inline int state_floats(int p, int n) {
    return (n * p + 3) & ~3;
}

int smem_floats(int p, int n) {
    // stT [n][p], CT [n][TT+PAD], BT [n][TS+PAD], Xs [TS][p],
    // MT [TS][TT+PAD], cs_row [TT], cs_col / dts / es [TS], total
    return state_floats(p, n) + n * (TT + PAD) + n * (TS + PAD) + TS * p
        + TS * (TT + PAD) + TT + 3 * TS + 1;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const T* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ state_out, float* __restrict__ cs,
           int S, int h, int g, int p, int n, int chunk) {
    extern __shared__ float4 smem4[];
    float* stT = reinterpret_cast<float*>(smem4);
    float* CT = stT + state_floats(p, n);
    float* BT = CT + n * (TT + PAD);
    float* Xs = BT + n * (TS + PAD);
    float* MT = Xs + TS * p;
    float* cs_row = MT + TS * (TT + PAD);
    float* cs_col = cs_row + TT;
    float* dts = cs_col + TS;
    float* es = dts + TS;
    float* s_total = es + TS;

    const int bh = blockIdx.x;
    const int bi = bh / h, hi = bh % h;
    const int gi = hi / (h / g);
    const int tid = threadIdx.x;
    const int tr = tid >> 4, tc = tid & 15;
    const float Af = to_f32(A[hi]);
    float* csr = cs + static_cast<size_t>(bh) * S;

    // element offsets in the [b,S,h,*] / [b,S,g,n] inputs at position t
    auto x_at = [&](int t) {
        return ((static_cast<size_t>(bi) * S + t) * h + hi) * p;
    };
    auto dt_at = [&](int t) {
        return (static_cast<size_t>(bi) * S + t) * h + hi;
    };
    auto bc_at = [&](int t) {
        return ((static_cast<size_t>(bi) * S + t) * g + gi) * n;
    };

    for (int i = tid; i < n * p; i += THREADS) stT[i] = 0.0f;

    for (int c0 = 0; c0 < S; c0 += chunk) {
        const int l = chunk < S - c0 ? chunk : S - c0;

        // 1) csum over the chunk: one warp, 32 positions at a time
        if (tid < 32) {
            float carry = 0.0f;
            for (int seg = 0; seg < l; seg += 32) {
                const int t = seg + tid;
                float v = t < l ? to_f32(dt[dt_at(c0 + t)]) * Af : 0.0f;
#pragma unroll
                for (int off = 1; off < 32; off <<= 1) {
                    const float u = __shfl_up_sync(FULL_WARP, v, off);
                    if (tid >= off) v += u;
                }
                v += carry;
                if (t < l) csr[c0 + t] = v;
                carry = __shfl_sync(FULL_WARP, v, 31);
            }
            if (tid == 0) *s_total = carry;
        }
        __syncthreads();

        // stage rows s0 .. s0+TS-1 of B and x (zero past the chunk)
        auto load_bx = [&](int s0) {
            for (int idx = tid; idx < TS * n; idx += THREADS) {
                const int r = idx / n, nn = idx % n;
                const int s = s0 + r;
                BT[nn * (TS + PAD) + r] =
                    s < l ? to_f32(Bm[bc_at(c0 + s) + nn]) : 0.0f;
            }
            for (int idx = tid; idx < TS * p; idx += THREADS) {
                const int r = idx / p, pp = idx % p;
                const int s = s0 + r;
                Xs[r * p + pp] = s < l ? to_f32(x[x_at(c0 + s) + pp]) : 0.0f;
            }
        };

        // 2) outputs, one 64-row tile of t at a time
        for (int t0 = 0; t0 < l; t0 += TT) {
            for (int idx = tid; idx < TT * n; idx += THREADS) {
                const int r = idx / n, nn = idx % n;
                const int t = t0 + r;
                CT[nn * (TT + PAD) + r] =
                    t < l ? to_f32(Cm[bc_at(c0 + t) + nn]) : 0.0f;
            }
            if (tid < TT)
                cs_row[tid] = t0 + tid < l ? csr[c0 + t0 + tid] : 0.0f;
            __syncthreads();

            float acc_in[4][4], acc_off[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc_in[i][j] = acc_off[i][j] = 0.0f;

            // carried state: C_t . state[pp, :]
            for (int nn = 0; nn < n; ++nn) {
                const float4 c4 = *reinterpret_cast<const float4*>(
                    &CT[nn * (TT + PAD) + tr * 4]);
                const float ca[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int pp = tc + 16 * j;
                    const float sv = pp < p ? stT[nn * p + pp] : 0.0f;
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc_off[i][j] = fmaf(ca[i], sv, acc_off[i][j]);
                }
            }

            // intra-chunk: column tiles up to the diagonal
            for (int s0 = 0; s0 <= t0; s0 += TS) {
                __syncthreads();       // last tile's BT / Xs / MT are read
                load_bx(s0);
                if (tid < TS) {
                    const int s = s0 + tid;
                    cs_col[tid] = s < l ? csr[c0 + s] : 0.0f;
                    dts[tid] = s < l ? to_f32(dt[dt_at(c0 + s)]) : 0.0f;
                }
                __syncthreads();

                float gs[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) gs[i][j] = 0.0f;
                for (int nn = 0; nn < n; ++nn) {
                    const float4 c4 = *reinterpret_cast<const float4*>(
                        &CT[nn * (TT + PAD) + tr * 4]);
                    const float ca[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float bv = BT[nn * (TS + PAD) + tc + 16 * j];
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            gs[i][j] = fmaf(ca[i], bv, gs[i][j]);
                    }
                }
                // decay mask: exp only on and below the diagonal
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int sl = tc + 16 * j, s = s0 + sl;
                    float mm[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int tl = tr * 4 + i, t = t0 + tl;
                        mm[i] = 0.0f;
                        if (t >= s && t < l)
                            mm[i] = gs[i][j] * expf(cs_row[tl] - cs_col[sl])
                                * dts[sl];
                    }
                    *reinterpret_cast<float4*>(&MT[sl * (TT + PAD) + tr * 4]) =
                        make_float4(mm[0], mm[1], mm[2], mm[3]);
                }
                __syncthreads();

                for (int sl = 0; sl < TS; ++sl) {
                    const float4 m4 = *reinterpret_cast<const float4*>(
                        &MT[sl * (TT + PAD) + tr * 4]);
                    const float ma[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int pp = tc + 16 * j;
                        const float xv = pp < p ? Xs[sl * p + pp] : 0.0f;
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            acc_in[i][j] = fmaf(ma[i], xv, acc_in[i][j]);
                    }
                }
            }

#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int tl = tr * 4 + i, t = t0 + tl;
                if (t >= l) continue;
                const float e = expf(cs_row[tl]);
                const size_t row = x_at(c0 + t);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int pp = tc + 16 * j;
                    if (pp < p)
                        y[row + pp] = from_f32<T>(acc_in[i][j] + acc_off[i][j] * e);
                }
            }
            __syncthreads();           // CT / cs_row are reloaded next tile
        }

        // 3) state update: thread owns state[pp = tc + 16 j][nn = tr + 16 i]
        const float total = *s_total;
        float ds[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) ds[i][j] = 0.0f;
        for (int s0 = 0; s0 < l; s0 += TS) {
            __syncthreads();
            load_bx(s0);
            if (tid < TS) {
                const int s = s0 + tid;
                dts[tid] = s < l ? to_f32(dt[dt_at(c0 + s)]) : 0.0f;
                es[tid] = s < l ? expf(total - csr[c0 + s]) : 0.0f;
            }
            __syncthreads();
            for (int sl = 0; sl < TS; ++sl) {
                const float e = es[sl], d = dts[sl];
                float xw[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int pp = tc + 16 * j;
                    xw[j] = pp < p ? e * (Xs[sl * p + pp] * d) : 0.0f;
                }
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int nn = tr + 16 * i;
                    if (nn < n) {
                        const float bv = BT[nn * (TS + PAD) + sl];
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            ds[i][j] = fmaf(xw[j], bv, ds[i][j]);
                    }
                }
            }
        }
        __syncthreads();
        const float et = expf(total);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int nn = tr + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int pp = tc + 16 * j;
                if (nn < n && pp < p)
                    stT[nn * p + pp] = stT[nn * p + pp] * et + ds[i][j];
            }
        }
        __syncthreads();
    }

    float* st = state_out + static_cast<size_t>(bh) * p * n;
    for (int idx = tid; idx < p * n; idx += THREADS) {
        const int pp = idx / n, nn = idx % n;
        st[idx] = stT[nn * p + pp];
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, float* state,
                   float* cs, int b, int S, int h, int g, int p, int n,
                   int chunk, cudaStream_t st) {
    const int bytes = smem_floats(p, n) * static_cast<int>(sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    ssd_kernel<T><<<b * h, THREADS, bytes, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const T*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<T*>(y), state, cs, S, h, g,
        p, n, chunk);
    return cudaGetLastError();
}

}  // namespace

// x, y: [b, S, h, p]; dt: [b, S, h]; A: [h]; Bm, Cm: [b, S, g, n]; all
// contiguous and of one dtype (DTYPE_F32 or DTYPE_BF16).  state: [b, h, p, n]
// float32; cs: [b * h, S] float32 scratch.  p <= 64, n <= 128, h a multiple
// of g, 1 <= chunk.  Launches on `stream`, never synchronises; returns the
// launch's cudaError_t (0 on success).
REPRO_EXPORT int ssd_scan_launch(const void* x, const void* dt, const void* A,
                                 const void* Bm, const void* Cm, void* y,
                                 void* state, void* cs, int b, int S, int h,
                                 int g, int p, int n, int chunk, int dtype,
                                 void* stream) {
    if (b <= 0 || S <= 0 || h <= 0 || g <= 0 || h % g != 0 || p <= 0
            || p > MAX_P || n <= 0 || n > MAX_N || chunk <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* state_f = static_cast<float*>(state);
    float* cs_f = static_cast<float*>(cs);
    cudaError_t err = cudaErrorInvalidValue;
    if (dtype == DTYPE_F32)
        err = launch<float>(x, dt, A, Bm, Cm, y, state_f, cs_f, b, S, h, g,
                            p, n, chunk, st);
    else if (dtype == DTYPE_BF16)
        err = launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state_f, cs_f, b, S,
                                    h, g, p, n, chunk, st);
    return static_cast<int>(err);
}

REPRO_EXPORT const char* ssd_scan_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
