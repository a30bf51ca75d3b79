// flash_attention — causal (or full) grouped-query attention by blockwise
// online softmax: q [B,S,H,D], k,v [B,S,KV,D] -> o [B,S,H,D].
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (grid (B*H, q blocks, k blocks) with the k axis sequential, the running
// max m, denominator l and f32 accumulator in VMEM scratch, GQA through the
// k/v index maps, fully masked blocks skipped with pl.when).
//
// Design for Hopper: one 128-thread block per (b*H + h, 64-row q tile); the
// k loop runs inside the block and stops at the causal bound, so blocks
// above the diagonal are never visited.  The KV head is h / (H / KV):
// repeated heads are never materialised.  Any S works: the q and k tails are
// masked (rows past S are computed on zeros and not stored, keys past S get
// the mask value), so there is no block halving and no host padding.
// Inputs of either dtype are widened to float32 as they are staged in shared
// memory; m, l and the accumulator are float32 registers and the products
// are float32 FMAs on the CUDA cores — no TF32, since the float32 case is
// held to 1e-5.  Masked scores are -1e30, not -inf, so exp(m_prev - m_new)
// never reads inf - inf; the output is acc / max(l, 1e-30) as in the
// reference.  Each thread owns a 4 x 8 patch of the 64 x 64 score tile and a
// 4 x D/8 patch of the output; P goes through shared memory between the two
// products.  At qwen2's shapes (B = 4, S = 512, bf16) the work is 8.4 MB
// and 1.9 GFLOP causal: bound by bytes (2.5 us) against the tensor cores'
// bf16 rate, but this first version runs the products on the CUDA cores in
// float32 (>= 28 us at 67 TFLOP/s); tensor cores are later work.
#include "common.cuh"
#include <math.h>

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 64;            // keys per k tile
constexpr int PAD = 4;            // keeps float4 rows 16-byte aligned
constexpr int THREADS = 128;      // 16 row groups x 8 column lanes
constexpr float NEG = -1e30f;

template <int D>
constexpr int smem_floats() {
    // QT [D][BQ+PAD], KT [D][BK+PAD], V [BK][D], PT [BK][BQ+PAD]
    return D * (BQ + PAD) + D * (BK + PAD) + BK * D + BK * (BQ + PAD);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H,
             int KV, float scale, int causal) {
    extern __shared__ float4 smem4[];
    float* QT = reinterpret_cast<float*>(smem4);
    float* KT = QT + D * (BQ + PAD);
    float* Vs = KT + D * (BK + PAD);
    float* PT = Vs + BK * D;

    constexpr int DJ = D / 8;          // output columns per thread
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H;
    const int kvh = h / (H / KV);
    const int q0 = blockIdx.y * BQ;
    const int tid = threadIdx.x;
    const int tr = tid >> 3;           // rows tr*4 .. tr*4+3
    const int tc = tid & 7;            // score cols tc+8j, out cols tc+8j

    // [B,S,H,D] / [B,S,KV,D] contiguous: row s of head h starts here
    const size_t q_base = (static_cast<size_t>(b) * S * H + h) * D;
    const size_t q_row = static_cast<size_t>(H) * D;
    const size_t k_base = (static_cast<size_t>(b) * S * KV + kvh) * D;
    const size_t k_row = static_cast<size_t>(KV) * D;

    for (int idx = tid; idx < BQ * D; idx += THREADS) {
        const int r = idx / D, dd = idx % D;
        const int s = q0 + r;
        QT[dd * (BQ + PAD) + r] =
            s < S ? to_f32(q[q_base + s * q_row + dd]) : 0.0f;
    }

    float m[4], l[4], acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG;
        l[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
    }

    const int n_k_all = (S + BK - 1) / BK;
    const int n_k_causal = (q0 + BQ - 1) / BK + 1;
    const int n_k = causal && n_k_causal < n_k_all ? n_k_causal : n_k_all;

    for (int kt = 0; kt < n_k; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();               // previous tile's KT / Vs / PT done
        for (int idx = tid; idx < BK * D; idx += THREADS) {
            const int c = idx / D, dd = idx % D;
            const int s = k0 + c;
            const bool in = s < S;
            KT[dd * (BK + PAD) + c] =
                in ? to_f32(k[k_base + s * k_row + dd]) : 0.0f;
            Vs[c * D + dd] = in ? to_f32(v[k_base + s * k_row + dd]) : 0.0f;
        }
        __syncthreads();

        float sc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
        for (int dd = 0; dd < D; ++dd) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&QT[dd * (BQ + PAD) + tr * 4]);
            const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
            float kv[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) kv[j] = KT[dd * (BK + PAD) + tc + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    sc[i][j] = fmaf(qa[i], kv[j], sc[i][j]);
        }

        // scale, mask, online softmax over this tile
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qp = q0 + tr * 4 + i;
            float mx = NEG;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int kp = k0 + tc + 8 * j;
                const bool ok = kp < S && (!causal || kp <= qp);
                sc[i][j] = ok ? sc[i][j] * scale : NEG;
                mx = fmaxf(mx, sc[i][j]);
            }
            // the 8 lanes of a row group are adjacent lanes of one warp
            mx = fmaxf(mx, __shfl_xor_sync(FULL_WARP, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL_WARP, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(FULL_WARP, mx, 4));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                sc[i][j] = expf(sc[i][j] - m_new);
                rs += sc[i][j];
            }
            rs += __shfl_xor_sync(FULL_WARP, rs, 1);
            rs += __shfl_xor_sync(FULL_WARP, rs, 2);
            rs += __shfl_xor_sync(FULL_WARP, rs, 4);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float4*>(&PT[(tc + 8 * j) * (BQ + PAD) + tr * 4]) =
                make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
        __syncthreads();

        // acc += P V over this tile's keys
#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            const float4 pv =
                *reinterpret_cast<const float4*>(&PT[c * (BQ + PAD) + tr * 4]);
            const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int j = 0; j < DJ; ++j) {
                const float vv = Vs[c * D + tc + 8 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = q0 + tr * 4 + i;
        if (s >= S) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < DJ; ++j)
            o[q_base + s * q_row + tc + 8 * j] = from_f32<T>(acc[i][j] / den);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, float scale, int causal,
                   cudaStream_t st) {
    constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
    // above 48 KB only after opting in (a host-side call, set every launch
    // so that it holds on whichever device is current)
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid(B * H, (S + BQ - 1) / BQ);
    flash_kernel<T, D><<<grid, THREADS, bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, scale,
        causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int KV, int D, float scale,
                     int causal, cudaStream_t st) {
    switch (D) {
        case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, scale, causal, st);
        case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, scale, causal, st);
        case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, scale, causal, st);
        case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, scale, causal, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q, o: [B, S, H, D]; k, v: [B, S, KV, D]; all contiguous, one dtype
// (DTYPE_F32 or DTYPE_BF16).  D in {16, 32, 64, 128}, H a multiple of KV.
// Launches on `stream`, never synchronises; returns the launch's
// cudaError_t (0 on success).
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int B, int S,
                                        int H, int KV, int D, float scale,
                                        int causal, int dtype, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if ((S + BQ - 1) / BQ > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (dtype == DTYPE_F32)
        err = launch_d<float>(q, k, v, o, B, S, H, KV, D, scale, causal, st);
    else if (dtype == DTYPE_BF16)
        err = launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, scale,
                                      causal, st);
    return static_cast<int>(err);
}

REPRO_EXPORT const char* flash_attention_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
