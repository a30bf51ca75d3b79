// ssd_scan — the Mamba2 SSD chunked scan (arXiv:2405.21060 §6):
// x [b,S,h,p], dt [b,S,h], A [h], B,C [b,S,g,n] -> y [b,S,h,p] and the final
// state [b,h,p,n] (carried in float32, returned in x's dtype).
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
// The element type decides the design — a contract of the function, not a
// fallback:
//
// float32 (held to 1e-4 against the sequential recurrence, which TF32 cannot
// meet): one 256-thread block per (batch, head) loops over the chunks in
// order with the state in shared memory (stored [n][p], 32 KB at p = 64,
// n = 128).  The [l, l] decay-score matrix (256 KB at l = 256) is never
// materialised: the chunk is walked in 64-row tiles of t and, inside each,
// 64-column tiles of s up to the diagonal; a 64 x 64 score tile goes through
// shared memory between the two products.  exp(csum_t - csum_s) is evaluated
// only where t >= s — above the diagonal the exponent is positive and can
// overflow, and the reference selects 0 there.  Any chunk length works;
// csum lives in a float32 scratch row per (batch, head) that the wrapper
// allocates.  The g -> h group repeat is index arithmetic (head h reads group
// h / (h/g)), never a copy.  All products are float32 FMAs on the CUDA cores.
// Each thread owns a 4 x 4 patch of a score tile and of the output tile, and
// 8 x 4 elements of the state update.
//
// bfloat16 (the served dtype): the state-passing form, chunks in parallel,
// every product on the tensor cores (wgmma, bf16 in, f32 accumulate), tiles
// by TMA over 4-D maps [b, S, h|g, p|n] (zero fill past S and past p / n),
// the state dim padded to NT = 64 (n <= 64 with an even count of heads a
// group, zamba2's) or 128 columns (every other n <= 128, mamba2's), so a
// B / C / state tile is 8 or 16 KB and a product over n takes NT / 16
// k-steps:
//   (i)   ssd_state_kernel, one warpgroup per (b*h, chunk): the chunk's
//         cumsum and its own state delta = w^T B (M = p, N = NT, K = l);
//         41 KB of shared memory at NT = 64, five blocks an SM, so all 640
//         of zamba2's run in one wave;
//   (ii)  ssd_pass_kernel, past FOLD_CHUNKS = 2 chunks only: in_{c+1} =
//         exp(total_c) in_c + delta_c in float32, elementwise — the only
//         sequential step.  Up to two chunks (a 512-token prefill at chunk
//         256) it folds away: in_1 = delta_0, which the state kernel of
//         chunk 0 also stores as the output kernel's hi / lo tiles, and the
//         output kernel's t tile 0 blocks of the last chunk write the final
//         state, exp(total_1) delta_0 + delta_1;
//   (iii) ssd_out_kernel, one warpgroup per (64-row t tile, chunk, two heads
//         of one group at NT = 64, one at NT = 128): C B^T once a tile pair for the
//         block's heads (zamba2's 80 heads share one group), masked and
//         decayed per head in registers, times x, on top of exp(csum) C
//         in_c^T; y through shared memory to TMA stores.
// At zamba2's (4, 512, 80, 1, 64, 64, 256) the output kernel is bound by
// latency — each block's chain of waits (its first tiles, one tile in
// flight, the stores' drain) at three blocks an SM — more than by its
// products or by the ~100 MB it reads through L2 (PERF.md, PR 22); the
// state kernel reads x from device memory once.  The bf16 bar against the sequential
// recurrence (2e-2) does not survive single bf16 roundings of the kernel's
// float32 intermediates: the masked scores spread as sqrt(n) (~11 at
// n = 128, 8 at 64), and a rounding of each, summed over a chunk, moves a
// small output by more than the bar's atol.  So every intermediate operand is carried as a pair of bf16
// (hi = bf16(v), lo = bf16(v - hi): ~16 significant bits) and multiplied
// twice — w = exp(total - csum) dt x, the masked scores with dt folded in,
// M' = (C B^T) exp(csum_t - csum_s) dt_s, and in_c — while x, B and C enter
// as they are stored.  ref.ssd_scan_chunked_ref(bf16_points=True) rounds at
// exactly these points.  At mamba2's shape the work is 4.0 GFLOP and 16.9
// MB: bound by bytes (5.0 us), the paired operands double the tensor-core
// work to ~8 GFLOP (8 us at peak).
#include "hopper.cuh"
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

// --------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma) fed by TMA, chunks in parallel
// --------------------------------------------------------------------------
constexpr int TC_THREADS = 128;   // one warpgroup
constexpr int TILE = 64;          // rows (positions) per tile
constexpr int PT = 64;            // head dim p, padded: the M / N of wgmma
constexpr int XB = PT * TILE * 2; // one x tile (a 64-column box): 8 KB
constexpr float LOG2E = 1.4426950408889634f;
// at most this many chunks there is no pass kernel: the state kernel of
// chunk 0 writes in_1 = delta_0 as hi / lo tiles and the output kernel
// writes the final state
constexpr int FOLD_CHUNKS = 2;

// The state dim n is padded to NT = 64 (n <= 64) or 128 columns: one B / C
// tile (NT / 64 boxes of 64 columns) is 8 or 16 KB, Q K^T-like products
// over n take NT / 16 k-steps.
template <int NT>
__host__ __device__ constexpr int bc_bytes() { return NT * TILE * 2; }
// smem of the chunk-state kernel: two stages of {x -> w_hi, B} and one w_lo
// tile (the product that reads it ends before the next tile's is written):
// 41 KB at NT = 64, so five blocks fit an SM
template <int NT>
__host__ __device__ constexpr int state_stage() { return XB + bc_bytes<NT>(); }
template <int NT>
__host__ __device__ constexpr int state_smem() {
    return 2 * state_stage<NT>() + XB + 1024 + 64;
}
// smem of the output kernel for HB heads a block: C, then two stages of
// {B, x of each head}; the incoming states' hi / lo tiles of each head sit
// over stage 1 (and past it) until the carried-state product is done.
// NT = 64, HB = 2: 64 KB; NT = 128, HB = 1: 72 KB — three blocks an SM.
template <int NT, int HB>
__host__ __device__ constexpr int out_stage() {
    return bc_bytes<NT>() + HB * XB;
}
template <int NT, int HB>
__host__ __device__ constexpr int out_in_bytes() {
    return 2 * HB * bc_bytes<NT>();
}
template <int NT, int HB>
__host__ __device__ constexpr int out_smem() {
    return bc_bytes<NT>() + out_stage<NT, HB>()
        + (out_in_bytes<NT, HB>() > out_stage<NT, HB>()
               ? out_in_bytes<NT, HB>() : out_stage<NT, HB>())
        + 1024 + 64;
}

// (a, b) as two packed bf16 pairs, hi = bf16(v) and lo = bf16(v - hi): each
// float is hi + lo to about 16 significant bits
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
    const __nv_bfloat162 l2 = __floats2bfloat162_rn(
        a - __low2float(h2), b - __high2float(h2));
    hi = *reinterpret_cast<const uint32_t*>(&h2);
    lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// byte offset of columns (col, col + 1), col even, of row r in a [64 x 64k]
// bf16 tile as TMA writes it at the 128-byte swizzle: boxes of 64 columns,
// 128-byte rows whose 16-byte pieces sit at piece ^ (r % 8)
__device__ __forceinline__ int swz128(int r, int col) {
    return (col >> 6) * (TILE * 128) + r * 128
        + ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// D[64 x NT] += A . B over a k16 step, both MN-major from shared memory
template <int NT>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[NT / 2], uint64_t da,
                                            uint64_t db) {
    if constexpr (NT == 64) wgmma_ss_n64_mn(d, da, db);
    else wgmma_ss_n128_mn(d, da, db);
}

// (i) one warpgroup per (b*h, chunk): the chunk's cumsum (to cs and total)
// and its own state delta[p, n] = sum_s w_s (x) B_s, w_s = fac_s x_s with
// fac_s = exp(total - csum_s) dt_s, as wgmma M = p, N = NT, K = s: w is
// written as hi / lo bf16 tiles over the landed x tile (MN-major A: the
// transpose bit), B is the MN-major B operand as it lands.
template <int NT>
__global__ void __launch_bounds__(TC_THREADS)
ssd_state_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_hi,
                 const __grid_constant__ CUtensorMap map_lo,
                 const bf16* __restrict__ dt, const bf16* __restrict__ A,
                 float* __restrict__ cs, float* __restrict__ totals,
                 float* __restrict__ delta, int S, int h, int g, int chunk) {
    constexpr int BC = bc_bytes<NT>();
    constexpr int STAGE = state_stage<NT>();
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* gbase = smem_raw + (base - raw);        // generic view of base
    const uint32_t sL = base + 2 * STAGE;            // w_lo
    const uint32_t bar = sL + XB;                    // bar, bar + 8: stages
    __shared__ float fac[2][TILE];                   // per tile, double-buffered
    __shared__ float s_warp[TC_THREADS / 32];
    __shared__ float s_total;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.x, c = blockIdx.y;
    const int bi = bh / h, hi = bh % h, gi = hi / (h / g);
    const int c0 = c * chunk;
    const int l = chunk < S - c0 ? chunk : S - c0;
    const int n_s = (l + TILE - 1) / TILE;
    const int nc = gridDim.y;
    float* csr = cs + static_cast<size_t>(bh) * S;
    auto dt_at = [&](int t) {
        return to_f32(dt[(static_cast<size_t>(bi) * S + t) * h + hi]);
    };

    if (tid == 0) {
        mbar_init(bar, 1);
        mbar_init(bar + 8, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(bar, XB + BC);
        tma_tile<64>(&map_x, base, bar, hi, c0, bi);
        tma_tile<NT>(&map_b, base + XB, bar, gi, c0, bi);
    }

    // csum over the chunk, 128 positions at a time: four warp scans joined
    // through shared memory; the thread at position l - 1 holds the total
    const float Af = to_f32(A[hi]);
    float carry = 0.0f;
    for (int seg = 0; seg < l; seg += TC_THREADS) {
        const int t = seg + tid;
        float v = t < l ? dt_at(c0 + t) * Af : 0.0f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float u = __shfl_up_sync(FULL_WARP, v, off);
            if (lane >= off) v += u;
        }
        if (lane == 31) s_warp[warp] = v;
        __syncthreads();
        float prev = carry;
        for (int w = 0; w < warp; ++w) prev += s_warp[w];
        v += prev;
        if (t < l) csr[c0 + t] = v;
        if (t == l - 1) {
            s_total = v;
            totals[static_cast<size_t>(bh) * nc + c] = v;
        }
        for (int w = 0; w < TC_THREADS / 32; ++w) carry += s_warp[w];
        __syncthreads();                                 // s_warp is reused
    }
    const float total = s_total;

    // the weights fac_s of tile j's rows; rows past the chunk (the next
    // chunk's) weigh 0.  A tile's csum and dt are fetched into registers a
    // tile ahead, so their latency hides behind the previous tile's work.
    float f_cs = 0.0f, f_dt = 0.0f;
    auto fetch = [&](int j) {
        const int s = j * TILE + tid;
        if (tid < TILE && s < l) {
            f_cs = csr[c0 + s];
            f_dt = dt_at(c0 + s);
        }
    };
    auto weights = [&](int j) {
        if (tid < TILE)
            fac[j & 1][tid] = j * TILE + tid < l
                ? expf(total - f_cs) * f_dt : 0.0f;
    };
    fetch(0);
    weights(0);
    __syncthreads();

    float d[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) d[i] = 0.0f;

    for (int j = 0; j < n_s; ++j) {
        const int st = j & 1;
        const uint32_t sW = base + st * STAGE;           // x, then w_hi
        const uint32_t sB = sW + XB;
        if (tid == 0 && j + 1 < n_s) {
            // the other stage was released by the barrier that ended j - 1
            const uint32_t nW = base + (1 - st) * STAGE;
            const uint32_t nbar = bar + 8 * (1 - st);
            mbar_expect_tx(nbar, XB + BC);
            tma_tile<64>(&map_x, nW, nbar, hi, c0 + (j + 1) * TILE, bi);
            tma_tile<NT>(&map_b, nW + XB, nbar, gi, c0 + (j + 1) * TILE, bi);
        }
        if (j + 1 < n_s) fetch(j + 1);
        mbar_wait(bar + 8 * st, (j >> 1) & 1);

        // w = fac * x as hi / lo, in the landed tile's swizzled layout (the
        // swizzle permutes 16-byte pieces within a row: row = piece / 8)
        uint8_t* gW = gbase + (sW - base);
        uint8_t* gL = gbase + (sL - base);
#pragma unroll
        for (int k = 0; k < XB / 16 / TC_THREADS; ++k) {
            const int q = tid + k * TC_THREADS;
            const float f = fac[st][q >> 3];
            uint4 v = *reinterpret_cast<const uint4*>(gW + q * 16);
            uint4 lo;
            uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
            uint32_t* lw = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const __nv_bfloat162 x2 =
                    *reinterpret_cast<const __nv_bfloat162*>(&vw[e]);
                split_pack(__bfloat162float(x2.x) * f,
                           __bfloat162float(x2.y) * f, vw[e], lw[e]);
            }
            *reinterpret_cast<uint4*>(gW + q * 16) = v;
            *reinterpret_cast<uint4*>(gL + q * 16) = lo;
        }
        fence_proxy_async();
        __syncthreads();

        // delta += w_hi^T B + w_lo^T B over this tile's 64 positions
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
            const uint64_t db = make_desc(sB + kk * 16 * 128, 8192, 1024, 1);
            wgmma_ss_mn<NT>(d, make_desc(sW + kk * 16 * 128, 8192, 1024, 1),
                            db);
            wgmma_ss_mn<NT>(d, make_desc(sL + kk * 16 * 128, 8192, 1024, 1),
                            db);
        }
        wgmma_commit();
        if (j + 1 < n_s) weights(j + 1);   // while the products run
        wgmma_wait_all();
        fence_regs(d);
        __syncthreads();               // stage st is free for tile j + 2
    }

    // d[4c + e]: row 16 warp + gr (+ 8 if e & 2), column 8c + 2 t4 + (e & 1);
    // with at most FOLD_CHUNKS chunks, chunk 0's delta is in_1 too: its hi /
    // lo [p, NT] tiles go through the free stages to two TMA stores
    const size_t tile = static_cast<size_t>(bh) * nc + c;
    float* out = delta + tile * PT * NT;
    const bool next_in = nc <= FOLD_CHUNKS && c + 1 < nc;
    const int r0 = 16 * warp + gr;
#pragma unroll
    for (int q = 0; q < NT / 8; ++q) {
        const int col = 8 * q + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
            const int r = r0 + 4 * e;              // r0, r0 + 8
            *reinterpret_cast<float2*>(out + r * NT + col) =
                make_float2(d[4 * q + e], d[4 * q + e + 1]);
            if (next_in)
                split_pack(d[4 * q + e], d[4 * q + e + 1],
                           *reinterpret_cast<uint32_t*>(gbase + swz128(r, col)),
                           *reinterpret_cast<uint32_t*>(gbase + BC
                                                        + swz128(r, col)));
        }
    }
    if (next_in) {
        fence_proxy_async();
        __syncthreads();
        if (tid == 0) {
#pragma unroll
            for (int bx = 0; bx < NT / 64; ++bx) {
                tma_store(&map_hi, base + bx * TILE * 128, 64 * bx, 0, 0,
                          static_cast<int>(tile + 1));
                tma_store(&map_lo, base + BC + bx * TILE * 128, 64 * bx, 0, 0,
                          static_cast<int>(tile + 1));
            }
            tma_store_drain();
        }
    }
}

// (ii) past FOLD_CHUNKS chunks, per (b, h): in_0 = 0, in_{c+1} =
// exp(total_c) in_c + delta_c in float32, elementwise, so the [p, NT] state
// is split over PASS_SPLIT blocks of one float4 a thread; each in_c is
// stored as hi / lo bf16 [p, NT] tiles (the layout the output kernel
// loads), the last state rounded once to bf16.
constexpr int PASS_THREADS = 256;
template <int NT>
__host__ __device__ constexpr int pass_split() {          // 4, 8
    return PT * NT / 4 / PASS_THREADS;
}
template <int NT>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass_kernel(const float* __restrict__ delta,
                const float* __restrict__ totals, bf16* __restrict__ in_hi,
                bf16* __restrict__ in_lo, bf16* __restrict__ state_out, int nc,
                int p, int n) {
    const int bh = blockIdx.x;
    const int idx = 4 * (blockIdx.y * PASS_THREADS + threadIdx.x);
    const size_t first = static_cast<size_t>(bh) * nc;   // tile of chunk 0
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 dl = *reinterpret_cast<const float4*>(delta + first * PT * NT + idx);
    float tot = totals[first];
    for (int c = 0; c < nc; ++c) {
        const size_t tile = (first + c) * PT * NT;
        const float4 d_c = dl;
        const float e = expf(tot);
        if (c + 1 < nc) {              // the next chunk's loads, issued early
            dl = *reinterpret_cast<const float4*>(delta + tile + PT * NT + idx);
            tot = totals[first + c + 1];
        }
        uint32_t h01, l01, h23, l23;
        split_pack(v.x, v.y, h01, l01);
        split_pack(v.z, v.w, h23, l23);
        *reinterpret_cast<uint2*>(in_hi + tile + idx) = make_uint2(h01, h23);
        *reinterpret_cast<uint2*>(in_lo + tile + idx) = make_uint2(l01, l23);
        v = make_float4(v.x * e + d_c.x, v.y * e + d_c.y, v.z * e + d_c.z,
                        v.w * e + d_c.w);
    }
    const int pp = idx / NT, nn = idx % NT;
    const float f[4] = {v.x, v.y, v.z, v.w};
    bf16* st = state_out + static_cast<size_t>(bh) * p * n;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (pp < p && nn + i < n)
            st[pp * n + nn + i] = __float2bfloat16_rn(f[i]);
}

// (iii) one warpgroup per (64-row t tile, chunk, HB heads of one group):
//   y_t = exp(csum_t) (C_t . in_c) + sum_{s <= t} M'_ts x_s
// with M'_ts = (C_t . B_s) exp(csum_t - csum_s) dt_s.  C B^T (K = n, both
// K-major, flash's Q K^T) is computed once a tile pair for the HB heads,
// which differ only in csum and dt; each head's M' goes from the score
// accumulator to hi / lo bf16 A fragments and meets its landed x tile
// (MN-major, flash's V) in two rs-wgmma.  The carried state C in_c^T (N =
// p, K = n; in_c as the hi / lo tiles the pass kernel or, with at most
// FOLD_CHUNKS chunks, the state kernel wrote) starts each head's
// accumulator; chunk 0 has none.  exp only on and below the diagonal; rows
// past the chunk are masked and not stored.  With at most FOLD_CHUNKS
// chunks the t tile 0 blocks of the last chunk write the final state.
template <int NT, int HB>
__global__ void __launch_bounds__(TC_THREADS, 3)
ssd_out_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_c,
               const __grid_constant__ CUtensorMap map_hi,
               const __grid_constant__ CUtensorMap map_lo,
               const __grid_constant__ CUtensorMap map_y,
               const float* __restrict__ delta,
               const float* __restrict__ totals, const bf16* __restrict__ dt,
               const float* __restrict__ cs, bf16* __restrict__ y,
               bf16* __restrict__ state_out, int S, int h, int g, int p,
               int n, int chunk, int y_tma) {
    constexpr int BC = bc_bytes<NT>();
    constexpr int STAGE = out_stage<NT, HB>();
    constexpr int TF = PT * NT;                      // floats of a state tile
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* gbase = smem_raw + (base - raw);
    const uint32_t sC = base;
    const uint32_t sStage = base + BC;               // + st * STAGE
    const uint32_t sIn = sStage + STAGE;             // head k: hi, lo at 2k BC
    const uint32_t bar0 = base + out_smem<NT, HB>() - 1024 - 64;
    // bar0: C; bar0 + 8 (1 + st): stage st
    __shared__ float csc[2][HB][TILE], dtc[2][HB][TILE];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, t4 = lane & 3;
    // the t tiles of one (chunk, heads) are neighbours in the grid, so the x
    // tiles they share are read from L2 (longest first among them)
    const int tt = gridDim.x - 1 - blockIdx.x;
    const int c = blockIdx.y, nc = gridDim.y;
    const int bh0 = blockIdx.z * HB;                 // the block's first head
    const int bi = bh0 / h, hi0 = bh0 % h, gi = hi0 / (h / g);
    const int c0 = c * chunk;
    const int l = chunk < S - c0 ? chunk : S - c0;
    const int t0 = tt * TILE;
    if (t0 >= l) return;                             // the last chunk is short
    const bool fold = nc <= FOLD_CHUNKS;

    if (tid == 0) {
        mbar_init(bar0, 1);
        mbar_init(bar0 + 8, 1);
        mbar_init(bar0 + 16, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        // C, and each head's in_c hi / lo tiles (none for chunk 0)
        mbar_expect_tx(bar0, BC + (c > 0 ? 2 * HB * BC : 0));
        tma_tile<NT>(&map_c, sC, bar0, gi, c0 + t0, bi);
        if (c > 0) {
#pragma unroll
            for (int k = 0; k < HB; ++k) {
                const int in_row = (bh0 + k) * nc + c;
                tma_tile<NT>(&map_hi, sIn + 2 * k * BC, bar0, 0, 0, in_row);
                tma_tile<NT>(&map_lo, sIn + (2 * k + 1) * BC, bar0, 0, 0,
                             in_row);
            }
        }
        mbar_expect_tx(bar0 + 8, STAGE);
        tma_tile<NT>(&map_b, sStage, bar0 + 8, gi, c0, bi);
#pragma unroll
        for (int k = 0; k < HB; ++k)
            tma_tile<64>(&map_x, sStage + BC + k * XB, bar0 + 8, hi0 + k, c0,
                         bi);
    }

    // this thread's rows of the tile: t0 + 16 warp + gr and + 8; csum of
    // each head at them, in log2 units
    const int tl0 = t0 + 16 * warp + gr, tl1 = tl0 + 8;
    float cl0[HB], cl1[HB], acc[HB][32];
#pragma unroll
    for (int k = 0; k < HB; ++k) {
        const float* csr = cs + static_cast<size_t>(bh0 + k) * S + c0;
        cl0[k] = tl0 < l ? csr[tl0] * LOG2E : 0.0f;
        cl1[k] = tl1 < l ? csr[tl1] * LOG2E : 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[k][i] = 0.0f;
    }

    if (c > 0) {
        mbar_wait(bar0, 0);

        // acc = C in_hi^T + C in_lo^T (N = p, K = n), then times exp(csum_t)
#pragma unroll
        for (int k = 0; k < HB; ++k) fence_regs(acc[k]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < HB; ++k) {
#pragma unroll
            for (int kk = 0; kk < NT / 16; ++kk) {
                const int col = kk * 16;
                const uint32_t o = (col / 64) * (TILE * 128) + (col % 64) * 2;
                const uint64_t da = make_desc(sC + o, 16, 1024, 1);
                wgmma_ss_n64(acc[k], da,
                             make_desc(sIn + 2 * k * BC + o, 16, 1024, 1), 1);
                wgmma_ss_n64(acc[k], da,
                             make_desc(sIn + (2 * k + 1) * BC + o, 16, 1024,
                                       1), 1);
            }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int k = 0; k < HB; ++k) {
            fence_regs(acc[k]);
            const float e0 = ex2(cl0[k]), e1 = ex2(cl1[k]);
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[k][i] *= (i & 2) ? e1 : e0;
        }
    }

    // csum (in log2 units) and dt of tile j's keys, each head; keys past the
    // chunk are masked and read as 0.  Fetched into registers a tile ahead
    // (the loads' latency hides behind the previous tile's products), stored
    // to shared memory while the products run.
    float k_cs[HB], k_dt[HB];
    auto fetch = [&](int j) {
        const int s = j * TILE + tid;
        const bool in = tid < TILE && s < l;
#pragma unroll
        for (int k = 0; k < HB; ++k) {
            k_cs[k] = in ? cs[static_cast<size_t>(bh0 + k) * S + c0 + s] * LOG2E
                         : 0.0f;
            k_dt[k] = in ? to_f32(dt[(static_cast<size_t>(bi) * S + c0 + s) * h
                                     + hi0 + k])
                         : 0.0f;
        }
    };
    auto keys = [&](int j) {
        if (tid < TILE) {
#pragma unroll
            for (int k = 0; k < HB; ++k) {
                csc[j & 1][k][tid] = k_cs[k];
                dtc[j & 1][k][tid] = k_dt[k];
            }
        }
    };
    fetch(0);
    keys(0);
    __syncthreads();                   // in tiles are read: stage 1 free

    for (int j = 0; j <= tt; ++j) {
        const int st = j & 1;
        const uint32_t sB = sStage + st * STAGE, sX = sB + BC;
        if (tid == 0 && j + 1 <= tt) {
            const uint32_t nB = sStage + (1 - st) * STAGE;
            const uint32_t nbar = bar0 + 8 * (2 - st);
            mbar_expect_tx(nbar, STAGE);
            tma_tile<NT>(&map_b, nB, nbar, gi, c0 + (j + 1) * TILE, bi);
#pragma unroll
            for (int k = 0; k < HB; ++k)
                tma_tile<64>(&map_x, nB + BC + k * XB, nbar, hi0 + k,
                             c0 + (j + 1) * TILE, bi);
        }
        if (j + 1 <= tt) fetch(j + 1);
        if (j == 0) mbar_wait(bar0, 0);
        mbar_wait(bar0 + 8 * (1 + st), (j >> 1) & 1);

        // scores C_t . B_s over the state dim: NT / 16 steps of k16, once
        // for the block's heads
        float sc[32];
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NT / 16; ++kk) {
            const int col = kk * 16;
            const uint32_t o = (col / 64) * (TILE * 128) + (col % 64) * 2;
            if (kk == 0)
                wgmma_ss_n64_first(sc, make_desc(sC + o, 16, 1024, 1),
                                   make_desc(sB + o, 16, 1024, 1));
            else
                wgmma_ss_n64(sc, make_desc(sC + o, 16, 1024, 1),
                             make_desc(sB + o, 16, 1024, 1), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        const bool diag = j == tt;
#pragma unroll
        for (int k = 0; k < HB; ++k) {
            // M' = score * 2^(csum_t - csum_s) dt_s where s <= t < l, else
            // 0; sc[4q + e] is row (e & 2 ? tl1 : tl0), key 8q + 2 t4 + (e & 1)
            uint32_t ph[4][4], pl[4][4];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
#pragma unroll
                for (int e = 0; e < 4; e += 2) {
                    const int tl = (e & 2) ? tl1 : tl0;
                    const float cl = (e & 2) ? cl1[k] : cl0[k];
                    float m[2];
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        const int sl = 8 * q + 2 * t4 + u;
                        const bool keep = tl < l
                            && (!diag || j * TILE + sl <= tl);
                        m[u] = keep ? sc[4 * q + e + u]
                                          * ex2(cl - csc[st][k][sl])
                                          * dtc[st][k][sl]
                                    : 0.0f;
                    }
                    // A fragment k step q / 2: registers (q & 1) * 2 + (e >> 1)
                    split_pack(m[0], m[1], ph[q >> 1][(q & 1) * 2 + (e >> 1)],
                               pl[q >> 1][(q & 1) * 2 + (e >> 1)]);
                }
            }

            // acc += M'_hi x + M'_lo x over this tile's 64 keys
            fence_regs(acc[k]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint64_t db = make_desc(sX + k * XB + kk * 16 * 128,
                                              8192, 1024, 1);
                wgmma_rs_n64(acc[k], ph[kk], db);
                wgmma_rs_n64(acc[k], pl[kk], db);
            }
            wgmma_commit();
            if (k == 0 && j + 1 <= tt) keys(j + 1);   // while the products run
            wgmma_wait_all();
            fence_regs(acc[k]);
        }
        __syncthreads();               // stage st and keys[st] are free
    }

    // y = acc, rows < l, columns < p: a whole tile through stage 0's x tiles
    // (free now) to one TMA store a head, where y's rows are whole 16-byte
    // pieces; else (and for a tile the chunk cuts) stored by each thread
    if (y_tma && t0 + TILE <= l) {
        uint8_t* gY = gbase + (sStage + BC - base);
        const int r0 = 16 * warp + gr;
#pragma unroll
        for (int k = 0; k < HB; ++k) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int col = 8 * q + 2 * t4;
                *reinterpret_cast<__nv_bfloat162*>(
                    gY + k * XB + swz128(r0, col)) =
                    __floats2bfloat162_rn(acc[k][4 * q], acc[k][4 * q + 1]);
                *reinterpret_cast<__nv_bfloat162*>(
                    gY + k * XB + swz128(r0 + 8, col)) =
                    __floats2bfloat162_rn(acc[k][4 * q + 2],
                                          acc[k][4 * q + 3]);
            }
        }
        fence_proxy_async();
        __syncthreads();
        if (tid == 0) {
#pragma unroll
            for (int k = 0; k < HB; ++k)
                tma_store(&map_y, sStage + BC + k * XB, 0, hi0 + k, c0 + t0,
                          bi);
            tma_store_drain();
        }
    } else {
        const size_t row_stride = static_cast<size_t>(h) * p;
#pragma unroll
        for (int k = 0; k < HB; ++k) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int col = 8 * q + 2 * t4;
#pragma unroll
                for (int e = 0; e < 4; e += 2) {
                    const int tl = (e & 2) ? tl1 : tl0;
                    if (tl >= l) continue;
                    bf16* dst = y + (static_cast<size_t>(bi) * S + c0 + tl)
                                    * row_stride
                                + static_cast<size_t>(hi0 + k) * p + col;
                    const float v0 = acc[k][4 * q + e];
                    const float v1 = acc[k][4 * q + e + 1];
                    if (col + 1 < p && (p & 1) == 0) {
                        *reinterpret_cast<__nv_bfloat162*>(dst) =
                            __floats2bfloat162_rn(v0, v1);
                    } else {
                        if (col < p) dst[0] = __float2bfloat16_rn(v0);
                        if (col + 1 < p) dst[1] = __float2bfloat16_rn(v1);
                    }
                }
            }
        }
    }

    // the final state (no pass kernel): exp(total_1) delta_0 + delta_1 over
    // two chunks, delta_0 over one — the pass kernel's arithmetic
    if (fold && c == nc - 1 && tt == 0) {
#pragma unroll
        for (int k = 0; k < HB; ++k) {
            const size_t first = static_cast<size_t>(bh0 + k) * nc;
            const float e = expf(totals[first + c]);
            bf16* st = state_out + static_cast<size_t>(bh0 + k) * p * n;
            for (int idx = 4 * tid; idx < TF; idx += 4 * TC_THREADS) {
                const float4 d_c = *reinterpret_cast<const float4*>(
                    delta + (first + c) * TF + idx);
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (c > 0)
                    v = *reinterpret_cast<const float4*>(delta + first * TF
                                                         + idx);
                v = make_float4(v.x * e + d_c.x, v.y * e + d_c.y,
                                v.z * e + d_c.z, v.w * e + d_c.w);
                const int pp = idx / NT, nn = idx % NT;
                const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    if (pp < p && nn + i < n)
                        st[pp * n + nn + i] = __float2bfloat16_rn(f[i]);
            }
        }
    }
}

template <int NT, int HB>
cudaError_t launch_tc_nt(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, void* y, bf16* state,
                         float* cs, float* delta, float* totals, bf16* in_hi,
                         bf16* in_lo, int b, int S, int h, int g, int p,
                         int px, int n, int nx, int chunk, cudaStream_t st) {
    const int nc = (S + chunk - 1) / chunk;
    const int n_tt = ((chunk < S ? chunk : S) + TILE - 1) / TILE;
    if (nc > 65535 || b * h / HB > 65535)
        return cudaErrorInvalidValue;
    // y goes out by TMA where its rows are whole 16-byte pieces
    const int y_tma = p % 8 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
    CUtensorMap mx, mb, mc, mhi, mlo, my{};
    if (!make_map<64>(&mx, x, b, S, h, px)
        || !make_map<NT>(&mb, Bm, b, S, g, nx)
        || !make_map<NT>(&mc, Cm, b, S, g, nx)
        || !make_map<NT>(&mhi, in_hi, b * h * nc, PT, 1)
        || !make_map<NT>(&mlo, in_lo, b * h * nc, PT, 1)
        || (y_tma && !make_map<64>(&my, y, b, S, h, p)))
        return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        ssd_state_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        state_smem<NT>());
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ssd_out_kernel<NT, HB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out_smem<NT, HB>());
    if (e != cudaSuccess) return e;
    const bf16* dtb = static_cast<const bf16*>(dt);
    ssd_state_kernel<NT><<<dim3(b * h, nc), TC_THREADS, state_smem<NT>(), st>>>(
        mx, mb, mhi, mlo, dtb, static_cast<const bf16*>(A), cs, totals, delta,
        S, h, g, chunk);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (nc > FOLD_CHUNKS) {
        ssd_pass_kernel<NT><<<dim3(b * h, pass_split<NT>()), PASS_THREADS, 0,
                              st>>>(delta, totals, in_hi, in_lo, state, nc, p,
                                    n);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    ssd_out_kernel<NT, HB><<<dim3(n_tt, nc, b * h / HB), TC_THREADS,
                             out_smem<NT, HB>(), st>>>(
        mx, mb, mc, mhi, mlo, my, delta, totals, dtb, cs,
        static_cast<bf16*>(y), state, S, h, g, p, n, chunk, y_tma);
    return cudaGetLastError();
}

// the state dim's tile width NT and the heads a block of the output kernel
// takes: NT = 64 with two heads a block where n <= 64 and the heads share a
// group evenly (zamba2's), else NT = 128 with one (mamba2's, and every other
// shape up to n = 128)
cudaError_t launch_tc(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, void* y, bf16* state,
                      float* cs, float* delta, float* totals, bf16* in_hi,
                      bf16* in_lo, int b, int S, int h, int g, int p, int px,
                      int n, int nx, int chunk, cudaStream_t st) {
    if (nx > 64 || (h / g) % 2)
        return launch_tc_nt<128, 1>(x, dt, A, Bm, Cm, y, state, cs, delta,
                                    totals, in_hi, in_lo, b, S, h, g, p, px,
                                    n, nx, chunk, st);
    return launch_tc_nt<64, 2>(x, dt, A, Bm, Cm, y, state, cs, delta, totals,
                               in_hi, in_lo, b, S, h, g, p, px, n, nx, chunk,
                               st);
}

cudaError_t launch_f32(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, float* state,
                       float* cs, int b, int S, int h, int g, int p, int n,
                       int chunk, cudaStream_t st) {
    const int bytes = smem_floats(p, n) * static_cast<int>(sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    ssd_kernel<float><<<b * h, THREADS, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<float*>(y), state, cs, S,
        h, g, p, n, chunk);
    return cudaGetLastError();
}

}  // namespace

// x, y: [b, S, h, p]; dt: [b, S, h]; A: [h]; Bm, Cm: [b, S, g, n]; all
// contiguous and of one dtype.  state: [b, h, p, n] in that dtype (the
// float32 state, rounded once for bf16); cs: [b * h, S] float32 scratch.
// p <= 64, n <= 128, h a multiple of g, 1 <= chunk.  DTYPE_F32 ignores the
// rest.  DTYPE_BF16: x's rows are px >= p elements long and B's / C's
// nx >= n (multiples of 8; the wrapper zero-pads), x, B, C 16-byte aligned;
// with nc = ceil(S / chunk) chunks and NT = 64 where nx <= 64, else 128,
// delta is [b * h * nc, 64, NT] float32, totals [b * h * nc] float32, in_hi
// and in_lo [b * h * nc, 64, NT] bf16 scratch.  Launches on `stream` (one
// kernel for float32; for bfloat16 two, three past FOLD_CHUNKS chunks),
// never synchronises; returns the first launch error (0 on success).
REPRO_EXPORT int ssd_scan_launch(const void* x, const void* dt, const void* A,
                                 const void* Bm, const void* Cm, void* y,
                                 void* state, void* cs, void* delta,
                                 void* totals, void* in_hi, void* in_lo,
                                 int b, int S, int h, int g, int p, int px,
                                 int n, int nx, int chunk, int dtype,
                                 void* stream) {
    if (b <= 0 || S <= 0 || h <= 0 || g <= 0 || h % g != 0 || p <= 0
            || p > MAX_P || n <= 0 || n > MAX_N || chunk <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* cs_f = static_cast<float*>(cs);
    if (dtype == DTYPE_F32)
        return static_cast<int>(launch_f32(x, dt, A, Bm, Cm, y,
                                           static_cast<float*>(state), cs_f,
                                           b, S, h, g, p, n, chunk, st));
    if (dtype != DTYPE_BF16 || px < p || px > PT || px % 8 != 0 || nx < n
            || nx > MAX_N || nx % 8 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm)
         | reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(in_hi)
         | reinterpret_cast<uintptr_t>(in_lo)) & 15)
        return static_cast<int>(cudaErrorMisalignedAddress);
    return static_cast<int>(launch_tc(
        x, dt, A, Bm, Cm, y, static_cast<bf16*>(state), cs_f,
        static_cast<float*>(delta), static_cast<float*>(totals),
        static_cast<bf16*>(in_hi), static_cast<bf16*>(in_lo), b, S, h, g, p,
        px, n, nx, chunk, st));
}

REPRO_EXPORT const char* ssd_scan_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
