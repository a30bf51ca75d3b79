// flash_attention — causal (or full) grouped-query attention by blockwise
// online softmax: q [B,S,H,D], k,v [B,S,KV,D] -> o [B,S,H,D].
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (grid (B*H, q blocks, k blocks) with the k axis sequential, the running
// max m, denominator l and f32 accumulator in VMEM scratch, GQA through the
// k/v index maps, fully masked blocks skipped with pl.when).
//
// Every design shares the reference's contract: the k loop runs inside the
// block and stops at the causal bound, so tiles above the diagonal are never
// visited; the KV head is h / (H / KV), never materialised; any S works,
// with rows past S computed on zeros and not stored and keys past S masked
// (no host padding, no block halving); masked scores are -1e30, not -inf,
// so exp(m_prev - m_new) never reads inf - inf; the output is
// acc / max(l, 1e-30).  The element type decides the design — a contract of
// the function, not a fallback:
//
// bfloat16 (the served path): the products run on the tensor cores.  One
// warpgroup (128 threads) owns a 64-row q tile (one block per (b*H + h, q
// tile)) and issues wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate).
// S = Q K^T reads Q and K from shared memory (K-major: d contiguous, as the
// model stores them); O += P V takes P from registers — the m64n64 f32
// score accumulator converts pairwise to the bf16 A fragment, so P never
// goes through shared memory — and V as an MN-major operand (transpose
// flag).  Tiles arrive by TMA (cp.async.bulk.tensor over 4-D maps of
// [B, S, heads, D], so rows past S within one batch row read as zeros) into
// a two-stage K/V ring whose mbarriers the block waits on; tile j+1 is in
// flight while tile j is multiplied.  The TMA swizzle (32, 64 or 128 B: one
// row of D <= 64) is the one the wgmma descriptors name.  Only the diagonal
// tile (and the ragged last one) is masked
// element-wise; log2(e) is folded into the scale, so each score costs one
// FFMA and one EX2; m, l and acc are f32 registers; P is rounded to bf16
// before P V, the rounding of the reference's own oracle
// (probs.astype(v.dtype)); l sums the unrounded P.  q tiles launch longest
// first (reversed blockIdx.y) so the grid's tail is short tiles.  At qwen2's
// shape (B = 4, S = 512, H = 14, KV = 2, D = 64) the work is 8.4 MB and
// 1.9 GFLOP causal: bound by bytes (2.5 us) against 1.9 us at 989 TFLOP/s.
//
// bfloat16 at D = 80 (zamba2's shared attention, 32 heads of 80, GQA 1:1),
// flash_tc80_kernel: a row of 160 bytes fits no swizzle.  At (4, 512, 32,
// 32, 80) the work is 42 MB and 5.4 GFLOP causal, bound by bytes (12.5 us);
// what the kernel pays for is moving K and V from L2 into shared memory
// once for every q tile that reads them, and the time a warpgroup's tensor
// cores stand idle through its softmax.  So:
//   * a tile is exactly 80 columns wide: a 64-column TMA box at the 128-byte
//     swizzle and a 16-column one at the 32-byte swizzle (10 KB for 64 rows,
//     no zero fill); Q K^T takes its five k16 steps across the two boxes,
//     and P V is a wgmma of N = 64 on the first box and one of N = 16 on the
//     second, each step with its own box's descriptor layout;
//   * a block holds 128 q rows in two warpgroups that share every K / V
//     tile, which halves the tiles moved per q row, in a four-stage ring
//     with full / empty mbarriers (each warp releases a stage it has read),
//     refilled by one thread of the first warpgroup: no __syncthreads per
//     tile.  Two blocks, four warpgroups, an SM take turns on the tensor
//     cores through one another's softmax.  A producer warp of its own was
//     measured and dropped: two blocks of nine warps leave 96 registers a
//     thread (an SM partition's 16K registers over five warps), ptxas spilled
//     and serialised the wgmma, and the kernel took 46.6 us against 28.3 us
//     (PERF.md, PR 22);
//   * a warpgroup issues P V of tile j and Q K^T of tile j + 1 back to back
//     before it waits, skips the causal tile it does not reach, and does
//     nothing when its 64 rows all lie past S;
//   * the output goes through the warpgroup's Q tile, in the layout TMA
//     writes, to two TMA stores, which drop the rows past S.
// Its arithmetic is the other head dims'.
//
// bfloat16 at D = 128 (llava's 32 heads over 8 KV heads, 576 patches + 512
// tokens), flash_tc128_kernel: at (4, 1088, 32, 8, 128) the work is 89 MB
// and 38.8 GFLOP causal, bound by operations (39.3 us at 989 TFLOP/s, 26.6
// us by bytes), in 1152 items of (head, 128 q rows) averaging 4.5 key
// tiles of 128: what a launch pays for is the time the tensor cores stand
// idle, in the softmax and at each item's start and end.  So the d = 80
// design at 128 columns (a row is two 64-column boxes at the 128-byte
// swizzle; 128 q rows in two consumer warpgroups sharing each K / V tile
// through full / empty mbarriers; the output by TMA store), and then:
//   * persistent blocks, one an SM, each walking items longest first; a
//     producer warp whose one thread loads the next item's Q as soon as the
//     last Q K^T of the current one is done and keeps a two-stage ring of
//     128-key tiles full across items; the output leaves through O tiles of
//     its own, so an item's stores finish under the next one's work;
//   * Q K^T as m64n128 (eight k16 steps; at 64 keys, m64n64, its shared
//     memory reads match the tensor cores' rate) and P V as eight m64n128
//     steps with P from registers;
//   * each warpgroup runs Q K^T, the softmax and P V in turn, waiting for
//     each product: the two warpgroups' products fill each other's softmax.
//     Issuing P V of tile j with Q K^T of tile j + 1 holds the scores, the
//     output and P live at once, and ptxas spilled at 128-key tiles;
//     ping-pong by named barriers was slower, and a producer warpgroup
//     that gives its registers up by setmaxnreg no faster than the warp
//     (PERF.md);
//   * both warpgroups walk the same tiles (the diagonal 128-key tile is the
//     last of each) and skip all tiles above it; in an item whose second
//     warpgroup holds no row (S = 1088 ends half way into one) the first
//     runs alone and the second only releases tiles.
// Its arithmetic is the other head dims'.
//
// bfloat16 at D = 224 (zamba2-7b's shared attention: 32 heads of 224, MHA,
// over the concatenated 7168-wide input; the model passes its own scale,
// (224 / 2)^-0.5), flash_tc224_kernel: at (4, 4096, 32, 32, 224) the work
// is 0.94 GB and 962 GFLOP causal, bound by operations (0.97 ms at 989
// TFLOP/s, 0.28 ms by bytes).  A 64-row tile of 224 columns is 28 KB, so a
// 128-row Q (56 KB) and a two-stage ring of 64-key K + V tiles (112 KB)
// fill one block an SM, and the output accumulator is 112 registers a
// thread.  So:
//   * a tile is exactly 224 columns wide: three 64-column TMA boxes at the
//     128-byte swizzle and a 32-column one at the 64-byte swizzle; Q K^T
//     takes its fourteen k16 steps across the four boxes (m64n64, each
//     step with its own box's descriptor layout), and P V is an N = 64
//     wgmma on each 64-column box and an N = 32 one on the last;
//   * 128 q rows in two warpgroups that share every K / V tile, eight warps
//     and no producer warp: a ninth would leave 168 registers a thread (an
//     SM partition's 16K over three warps) against the 112 accumulators, 32
//     scores and 16 P fragments each thread holds.  Thread 0 loads Q and
//     the first two tiles; after that, each warpgroup counts its release of
//     a stage in shared memory, and the one that releases it last loads the
//     tile two ahead there, so no warp waits on the other warpgroup;
//   * each warpgroup runs Q K^T, the softmax and P V in turn, waiting for
//     each product, as at D = 128: the two warpgroups' products fill each
//     other's softmax;
//   * the output goes through the warpgroup's Q tile, in the layout TMA
//     writes, to four TMA stores, which drop the rows past S.
// Its arithmetic is the other head dims'.
//
// float32: the products stay f32 FMAs on the CUDA cores (inputs staged in
// shared memory, each thread a 4 x 8 patch of the score tile and a 4 x D/8
// patch of the output, P through shared memory): the f32 case is held to
// 1e-5, which TF32 tensor cores cannot meet.
#include "hopper.cuh"
#include <math.h>

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 64;            // keys per k tile
constexpr int THREADS = 128;      // one warpgroup
constexpr float NEG = -1e30f;

// --------------------------------------------------------------------------
// float32: CUDA cores
// --------------------------------------------------------------------------
constexpr int PAD = 4;            // keeps float4 rows 16-byte aligned

template <int D>
constexpr int f32_smem_floats() {
    // QT [D][BQ+PAD], KT [D][BK+PAD], V [BK][D], PT [BK][BQ+PAD]
    return D * (BQ + PAD) + D * (BK + PAD) + BK * D + BK * (BQ + PAD);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int KV, float scale, int causal) {
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
        QT[dd * (BQ + PAD) + r] = s < S ? q[q_base + s * q_row + dd] : 0.0f;
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
            KT[dd * (BK + PAD) + c] = in ? k[k_base + s * k_row + dd] : 0.0f;
            Vs[c * D + dd] = in ? v[k_base + s * k_row + dd] : 0.0f;
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

        // acc += P V over this tile's keys (unrolled by 2 at D = 80, where
        // 4 leaves ptxas at 128 registers with a 4-byte spill, and at 224)
#pragma unroll (D == 80 || D == 224 ? 2 : 4)
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
            o[q_base + s * q_row + tc + 8 * j] = acc[i][j] / den;
    }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KV, float scale, int causal,
                       cudaStream_t st) {
    constexpr int bytes = f32_smem_floats<D>() * static_cast<int>(sizeof(float));
    // above 48 KB only after opting in (a host-side call, set every launch
    // so that it holds on whichever device is current)
    cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid(B * H, (S + BQ - 1) / BQ);
    flash_f32_kernel<D><<<grid, THREADS, bytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, scale,
        causal);
    return cudaGetLastError();
}

// --------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma) fed by TMA (helpers in hopper.cuh)
// --------------------------------------------------------------------------
// Q tile, then two K/V stages, then three mbarriers; +1024 to align the
// base to the 128-byte swizzle's 1024-byte repeat.  A row of D <= 64 bf16
// is one swizzle row (32, 64 or 128 bytes); D = 80 and D = 128 have designs
// of their own.
template <int D>
constexpr int tc_smem_bytes() {
    return 5 * Tile<D>::BYTES + 1024 + 64;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                bf16* __restrict__ o, int S, int H, int KV, float scale_log2,
                int causal) {
    static_assert(D == 16 || D == 32 || D == 64, "one swizzle row of D");
    using T = Tile<D>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sQ = base;
    const uint32_t barQ = base + 5 * T::BYTES;
    // stage st: K at base + (1 + 2 st) tiles, V right after, barrier barQ + 8 (1 + st)

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;       // fragment row / column pair
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H;
    const int kvh = h / (H / KV);
    const int qt = gridDim.y - 1 - blockIdx.y;   // longest tiles first
    const int q0 = qt * BQ;
    const int n_k_all = (S + BK - 1) / BK;
    const int n_k = causal && qt + 1 < n_k_all ? qt + 1 : n_k_all;

    if (tid == 0) {
        mbar_init(barQ, 1);
        mbar_init(barQ + 8, 1);
        mbar_init(barQ + 16, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(barQ, T::BYTES);
        tma_tile<D>(&map_q, sQ, barQ, h, q0, b);
        mbar_expect_tx(barQ + 8, 2 * T::BYTES);
        tma_tile<D>(&map_k, base + T::BYTES, barQ + 8, kvh, 0, b);
        tma_tile<D>(&map_v, base + 2 * T::BYTES, barQ + 8, kvh, 0, b);
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;   // rows g and g + 8
    const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;

    mbar_wait(barQ, 0);
    for (int j = 0; j < n_k; ++j) {
        const int st = j & 1;
        const uint32_t sK = base + (1 + 2 * st) * T::BYTES;
        const uint32_t sV = sK + T::BYTES;
        if (tid == 0 && j + 1 < n_k) {
            // the other stage was released by the barrier that ended j - 1
            const uint32_t nK = base + (3 - 2 * st) * T::BYTES;
            const uint32_t nbar = barQ + 8 * (2 - st);
            mbar_expect_tx(nbar, 2 * T::BYTES);
            tma_tile<D>(&map_k, nK, nbar, kvh, (j + 1) * BK, b);
            tma_tile<D>(&map_v, nK + T::BYTES, nbar, kvh, (j + 1) * BK, b);
        }
        mbar_wait(barQ + 8 * (1 + st), (j >> 1) & 1);

        // S = Q K^T: D / 16 steps of k16 over the head dim
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.0f;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = kk * 32;           // head-dim column 16 kk
            wgmma_ss_n64(s, make_desc(sQ + off, 16, T::ATOM_B, T::LAYOUT),
                         make_desc(sK + off, 16, T::ATOM_B, T::LAYOUT), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // mask the diagonal / ragged tile, online softmax (m in score units,
        // p = 2^(s * scale_log2 - m * scale_log2), one FFMA and one EX2 per
        // score); s[4c + e] is row (e < 2 ? g : g + 8), key 8c + 2t + (e & 1)
        const int k0 = j * BK;
        const bool masked = (causal && j == qt) || k0 + BK > S;
        float mx0 = NEG, mx1 = NEG;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            if (masked) {
                const int kp = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
                const int qp = (i & 2) ? row1 : row0;
                if (kp >= S || (causal && kp > qp)) s[i] = NEG;
            }
            if (i & 2) mx1 = fmaxf(mx1, s[i]);
            else mx0 = fmaxf(mx0, s[i]);
        }
        // a row's 64 keys lie in the 4 lanes of one quad
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_WARP, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_WARP, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_WARP, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_WARP, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float a0 = ex2((m0 - mn0) * scale_log2);
        const float a1 = ex2((m1 - mn1) * scale_log2);
        m0 = mn0;
        m1 = mn1;
        const float off0 = -mn0 * scale_log2, off1 = -mn1 * scale_log2;
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const float p = ex2(fmaf(s[i], scale_log2, (i & 2) ? off1 : off0));
            s[i] = p;
            if (i & 2) rs1 += p;
            else rs0 += p;
        }
        l0 = l0 * a0 + rs0;          // this lane's share; the quad sums last
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;

        // O += P V: P's accumulator layout is the bf16 A fragment, pairwise
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
            pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // keys 16 kk .. 16 kk + 15
            wgmma_pv<D>(acc, pa[kk],
                        make_desc(sV + kk * 16 * T::ROW_B, T::BOX_B,
                                  T::ATOM_B, T::LAYOUT));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        __syncthreads();             // stage st is free for tile j + 2
    }

    l0 += __shfl_xor_sync(FULL_WARP, l0, 1);
    l0 += __shfl_xor_sync(FULL_WARP, l0, 2);
    l1 += __shfl_xor_sync(FULL_WARP, l1, 1);
    l1 += __shfl_xor_sync(FULL_WARP, l1, 2);
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    const size_t row_stride = static_cast<size_t>(H) * D;
    bf16* o0 = o + (static_cast<size_t>(b) * S + row0) * row_stride + h * D;
    bf16* o1 = o0 + 8 * row_stride;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
        const int col = 8 * c + 2 * t;
        if (row0 < S)
            *reinterpret_cast<__nv_bfloat162*>(o0 + col) = __floats2bfloat162_rn(
                acc[4 * c] / den0, acc[4 * c + 1] / den0);
        if (row1 < S)
            *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
                acc[4 * c + 2] / den1, acc[4 * c + 3] / den1);
    }
}

// --------------------------------------------------------------------------
// bfloat16 at head dim 80: a tile exactly 80 columns wide, 128 q rows a
// block in two warpgroups that share each K / V tile
// --------------------------------------------------------------------------
// The D = 80 tile plan: the TMA boxes of one [64 rows x 80] tile, each
// {columns, swizzle row bytes} — a 64-column box at the 128-byte swizzle,
// then a 16-column box at the 32-byte swizzle; no column is zero fill.
constexpr int D80_BOX_COLS[2] = {64, 16};
constexpr int D80_BOX_ROW_B[2] = {128, 32};
static_assert(D80_BOX_COLS[0] + D80_BOX_COLS[1] == 80
              && D80_BOX_COLS[0] * 2 == D80_BOX_ROW_B[0]
              && D80_BOX_COLS[1] * 2 == D80_BOX_ROW_B[1],
              "the D = 80 boxes cover 80 columns, each one swizzle row");
constexpr int D80_WG = 2;                          // consumer warpgroups
constexpr int D80_BQ = 64 * D80_WG;                // q rows a block
constexpr int D80_BK = BK;                         // keys a k tile
constexpr int D80_THREADS = 128 * D80_WG;
constexpr int D80_STAGES = 4;                      // K/V ring depth
constexpr int D80_BOX_A = 64 * D80_BOX_ROW_B[0];   // 8 KB
constexpr int D80_TILE = D80_BOX_A + 64 * D80_BOX_ROW_B[1];   // 10 KB
// Q (one tile a warpgroup, reused for the output), the K/V ring, then
// 1 + 2 STAGES mbarriers: 100 KB and alignment, so two blocks fit an SM
constexpr int D80_SMEM =
    (D80_WG + 2 * D80_STAGES) * D80_TILE + 1024 + 8 * (1 + 2 * D80_STAGES);

// S = Q K^T over the 80 columns: four k16 steps in the 128-byte box, one in
// the 32-byte box, each step's descriptors in its own box's layout
__device__ __forceinline__ void qk80(float (&s)[32], uint32_t sQ,
                                     uint32_t sK) {
    wgmma_ss_n64_first(s, make_desc(sQ, 16, 1024, 1),
                       make_desc(sK, 16, 1024, 1));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
        wgmma_ss_n64(s, make_desc(sQ + kk * 32, 16, 1024, 1),
                     make_desc(sK + kk * 32, 16, 1024, 1), 1);
    wgmma_ss_n64(s, make_desc(sQ + D80_BOX_A, 16, 256, 3),
                 make_desc(sK + D80_BOX_A, 16, 256, 3), 1);
}

__global__ void __launch_bounds__(D80_THREADS, 2)
flash_tc80_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_q16,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_k16,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_v16,
                  const __grid_constant__ CUtensorMap map_o,
                  const __grid_constant__ CUtensorMap map_o16, int S, int H,
                  int KV, float scale_log2, int causal) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
    const uint32_t sKV = base + D80_WG * D80_TILE;   // stage st: K, then V
    const uint32_t barQ = sKV + 2 * D80_STAGES * D80_TILE;
    // full[st] at barQ + 8 (1 + st), empty[st] at barQ + 8 (1 + STAGES + st)

    const int tid = threadIdx.x;
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H;
    const int kvh = h / (H / KV);
    const int qt = gridDim.y - 1 - blockIdx.y;      // longest tiles first
    const int q0 = qt * D80_BQ;
    const int n_k_all = (S + D80_BK - 1) / D80_BK;
    const int n_k = causal && 2 * qt + 2 < n_k_all ? 2 * qt + 2 : n_k_all;
    const int n_wg = q0 + 64 < S ? 2 : 1;            // warpgroups with rows

    if (tid == 0) {
        mbar_init(barQ, 1);
        for (int st = 0; st < D80_STAGES; ++st) {
            mbar_init(barQ + 8 * (1 + st), 1);
            mbar_init(barQ + 8 * (1 + D80_STAGES + st), 4 * n_wg);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // K / V tile j into stage j % STAGES (thread 0: the first STAGES tiles
    // now, each later one once both warpgroups have released its stage)
    auto load_kv = [&](int j) {
        const int st = j % D80_STAGES;
        const uint32_t full = barQ + 8 * (1 + st);
        const uint32_t sK = sKV + 2 * st * D80_TILE;
        const uint32_t sV = sK + D80_TILE;
        mbar_expect_tx(full, 2 * D80_TILE);
        tma_load(&map_k, sK, full, 0, kvh, j * D80_BK, b);
        tma_load(&map_k16, sK + D80_BOX_A, full, 64, kvh, j * D80_BK, b);
        tma_load(&map_v, sV, full, 0, kvh, j * D80_BK, b);
        tma_load(&map_v16, sV + D80_BOX_A, full, 64, kvh, j * D80_BK, b);
    };
    if (tid == 0) {
        mbar_expect_tx(barQ, D80_WG * D80_TILE);
        for (int w = 0; w < D80_WG; ++w) {
            const uint32_t dst = base + w * D80_TILE;
            tma_load(&map_q, dst, barQ, 0, h, q0 + 64 * w, b);
            tma_load(&map_q16, dst + D80_BOX_A, barQ, 64, h, q0 + 64 * w, b);
        }
        for (int j = 0; j < n_k && j < D80_STAGES; ++j) load_kv(j);
    }

    const int wg = tid >> 7;
    if (wg >= n_wg) return;                          // rows all past S
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;           // fragment row / col pair
    const int diag = 2 * qt + wg;                    // its diagonal tile
    const int n_kw = causal && diag + 1 < n_k_all ? diag + 1 : n_k_all;
    const uint32_t sQ = base + wg * D80_TILE;
    const int row0 = q0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;

    // acc[4c + e]: row (e < 2 ? g : g + 8), column 8c + 2t + (e & 1); columns
    // 0 .. 63 in acc, 64 .. 79 in acc16
    float acc[32], acc16[8], s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc16[i] = 0.0f;
    float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(barQ, 0);
    mbar_wait(barQ + 8, 0);
    wgmma_fence();
    qk80(s, sQ, sKV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    for (int j = 0; j < n_kw; ++j) {
        const int st = j % D80_STAGES;
        const uint32_t sV = sKV + (2 * st + 1) * D80_TILE;

        // mask the diagonal / ragged tile, online softmax (m in score units,
        // p = 2^(s * scale_log2 - m * scale_log2)); s[4c + e] is row
        // (e < 2 ? g : g + 8), key 8c + 2t + (e & 1)
        const int k0 = j * D80_BK;
        const bool masked = (causal && j == diag) || k0 + D80_BK > S;
        float mx0 = NEG, mx1 = NEG;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            if (masked) {
                const int kp = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
                const int qp = (i & 2) ? row1 : row0;
                if (kp >= S || (causal && kp > qp)) s[i] = NEG;
            }
            if (i & 2) mx1 = fmaxf(mx1, s[i]);
            else mx0 = fmaxf(mx0, s[i]);
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_WARP, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_WARP, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_WARP, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_WARP, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float a0 = ex2((m0 - mn0) * scale_log2);
        const float a1 = ex2((m1 - mn1) * scale_log2);
        m0 = mn0;
        m1 = mn1;
        const float off0 = -mn0 * scale_log2, off1 = -mn1 * scale_log2;
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const float p = ex2(fmaf(s[i], scale_log2, (i & 2) ? off1 : off0));
            s[i] = p;
            if (i & 2) rs1 += p;
            else rs0 += p;
        }
        l0 = l0 * a0 + rs0;
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? a1 : a0;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc16[i] *= (i & 2) ? a1 : a0;

        // O += P V (P rounded to bf16, pairwise from the score accumulator),
        // V read in both boxes: N = 64 at the 128-byte swizzle, N = 16 at
        // the 32-byte one
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
            pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        fence_regs(acc);
        fence_regs(acc16);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {   // keys 16 kk .. 16 kk + 15
            wgmma_rs_n64(acc, pa[kk], make_desc(sV + kk * 16 * 128, 8192,
                                                1024, 1));
            wgmma_rs_n16(acc16, pa[kk], make_desc(sV + D80_BOX_A + kk * 16 * 32,
                                                  2048, 256, 3));
        }
        wgmma_commit();
        if (j + 1 < n_kw) {
            const int nst = (j + 1) % D80_STAGES;
            mbar_wait(barQ + 8 * (1 + nst), ((j + 1) / D80_STAGES) & 1);
            wgmma_fence();
            qk80(s, sQ, sKV + 2 * nst * D80_TILE);
            wgmma_commit();
        }
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(acc16);
        fence_regs(s);
        if (lane == 0) mbar_arrive(barQ + 8 * (1 + D80_STAGES + st));
        if (tid == 0 && j + D80_STAGES < n_k) {
            mbar_wait(barQ + 8 * (1 + D80_STAGES + st), (j / D80_STAGES) & 1);
            load_kv(j + D80_STAGES);
        }
    }

    l0 += __shfl_xor_sync(FULL_WARP, l0, 1);
    l0 += __shfl_xor_sync(FULL_WARP, l0, 2);
    l1 += __shfl_xor_sync(FULL_WARP, l1, 1);
    l1 += __shfl_xor_sync(FULL_WARP, l1, 2);
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);

    // epilogue: O into this warpgroup's Q tile (its last reader, Q K^T, is
    // done) in the layout TMA loads write — 16-byte pieces of a row
    // permuted by the swizzle: piece ^= address bits 7.. (row % 8 in the
    // 128-byte box, (row / 4) % 2 in the 32-byte one) — then two TMA stores,
    // which drop the rows past S
    named_sync(1 + wg, 128);
    uint8_t* gQ = gbase + (sQ - base);
    const int r0 = 16 * warp + g, r1 = r0 + 8;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<__nv_bfloat162*>(
            gQ + r0 * 128 + ((c ^ (r0 & 7)) << 4) + 4 * t) =
            __floats2bfloat162_rn(acc[4 * c] / den0, acc[4 * c + 1] / den0);
        *reinterpret_cast<__nv_bfloat162*>(
            gQ + r1 * 128 + ((c ^ (r1 & 7)) << 4) + 4 * t) =
            __floats2bfloat162_rn(acc[4 * c + 2] / den1,
                                  acc[4 * c + 3] / den1);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        *reinterpret_cast<__nv_bfloat162*>(
            gQ + D80_BOX_A + r0 * 32 + ((c ^ ((r0 >> 2) & 1)) << 4) + 4 * t) =
            __floats2bfloat162_rn(acc16[4 * c] / den0,
                                  acc16[4 * c + 1] / den0);
        *reinterpret_cast<__nv_bfloat162*>(
            gQ + D80_BOX_A + r1 * 32 + ((c ^ ((r1 >> 2) & 1)) << 4) + 4 * t) =
            __floats2bfloat162_rn(acc16[4 * c + 2] / den1,
                                  acc16[4 * c + 3] / den1);
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if ((tid & 127) == 0) {
        tma_store(&map_o, sQ, 0, h, q0 + 64 * wg, b);
        tma_store(&map_o16, sQ + D80_BOX_A, 64, h, q0 + 64 * wg, b);
        tma_store_drain();
    }
}

cudaError_t launch_tc80(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, float scale, int causal,
                        cudaStream_t st) {
    if (reinterpret_cast<uintptr_t>(o) & 15) return cudaErrorMisalignedAddress;
    CUtensorMap mq, mq16, mk, mk16, mv, mv16, mo, mo16;
    if (!make_map<64>(&mq, q, B, S, H, 80)
        || !make_map<16>(&mq16, q, B, S, H, 80)
        || !make_map<64>(&mk, k, B, S, KV, 80)
        || !make_map<16>(&mk16, k, B, S, KV, 80)
        || !make_map<64>(&mv, v, B, S, KV, 80)
        || !make_map<16>(&mv16, v, B, S, KV, 80)
        || !make_map<64>(&mo, o, B, S, H, 80)
        || !make_map<16>(&mo16, o, B, S, H, 80))
        return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc80_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        D80_SMEM);
    if (e != cudaSuccess) return e;
    const dim3 grid(B * H, (S + D80_BQ - 1) / D80_BQ);
    flash_tc80_kernel<<<grid, D80_THREADS, D80_SMEM, st>>>(
        mq, mq16, mk, mk16, mv, mv16, mo, mo16, S, H, KV,
        scale * 1.4426950408889634f, causal);
    return cudaGetLastError();
}

// --------------------------------------------------------------------------
// bfloat16 at head dim 128: persistent blocks, each walking (head, q tile)
// items with two consumer warpgroups and a producer warp
// --------------------------------------------------------------------------
// The D = 128 tile plan: the TMA boxes of one row of 128 columns, each
// {columns, swizzle row bytes} — two 64-column boxes at the 128-byte
// swizzle; no column is zero fill.
constexpr int D128_BOX_COLS[2] = {64, 64};
constexpr int D128_BOX_ROW_B[2] = {128, 128};
static_assert(D128_BOX_COLS[0] + D128_BOX_COLS[1] == 128
              && D128_BOX_COLS[0] * 2 == D128_BOX_ROW_B[0]
              && D128_BOX_COLS[1] * 2 == D128_BOX_ROW_B[1],
              "the D = 128 boxes cover 128 columns, each one swizzle row");
constexpr int D128_BK = 128;                       // keys a k tile
constexpr int D128_STAGES = 2;                     // K/V ring depth
constexpr int D128_WG = 2;                         // consumer warpgroups
constexpr int D128_BQ = 64 * D128_WG;              // q rows an item
// + one producer warp: nine warps leave 168 registers a thread (an SM
// partition's 16K over three warps), which the sequential loop below fits
constexpr int D128_THREADS = 128 * D128_WG + 32;
constexpr int D128_ROW_B = D128_BOX_ROW_B[0];      // a box's row: 128 B
constexpr int D128_BOX_B = 64 * D128_ROW_B;         // 64 rows of a box: 8 KB
constexpr int D128_QTILE = 2 * D128_BOX_B;          // 64 q rows: 16 KB
constexpr int D128_KBOX = D128_BK * D128_ROW_B;     // 128 rows of a box
constexpr int D128_KVTILE = 2 * D128_KBOX;          // 128 keys of K (or V)
constexpr int D128_NS = D128_BK / 2;                // score registers
// Q and O (a tile of each a warpgroup), the K/V ring, then the mbarriers
// (Q full, Q empty, STAGES full, STAGES empty), and alignment: 193 KB, one
// block an SM
constexpr int D128_SMEM = 2 * D128_WG * D128_QTILE
    + 2 * D128_STAGES * D128_KVTILE + 1024 + 8 * (2 + 2 * D128_STAGES);
static_assert(D128_SMEM <= 232448, "one block's shared memory");

// S = Q K^T over the 128 columns: eight m64n128k16 steps, four in each box
// (Q's box holds 64 rows, K's 128: one N = 128 operand of 16 atoms)
__device__ __forceinline__ void qk128(float (&s)[D128_NS], uint32_t sQ,
                                      uint32_t sK) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        wgmma_ss_n128(s, make_desc(sQ + (kk >> 2) * D128_BOX_B + col, 16,
                                   1024, 1),
                      make_desc(sK + (kk >> 2) * D128_KBOX + col, 16, 1024,
                                1),
                      kk > 0);
    }
}

// O += P V over the 128 keys of one tile: eight m64n128k16 steps, P from
// registers, V MN-major (its two column boxes D128_KBOX apart)
__device__ __forceinline__ void pv128(float (&acc)[64],
                                      const uint32_t (&pa)[D128_BK / 16][4],
                                      uint32_t sV) {
#pragma unroll
    for (int kk = 0; kk < D128_BK / 16; ++kk)       // keys 16 kk ..
        wgmma_rs_n128(acc, pa[kk], make_desc(sV + kk * 16 * D128_ROW_B,
                                             D128_KBOX, 1024, 1));
}

// Mask the diagonal / ragged tile whose first key is k0 (where `masked`),
// then the online softmax over it (m in score units, p = 2^(s * scale_log2
// - m * scale_log2)): p into s, the rescale of the earlier tiles into a0 /
// a1, this lane's row sums into rs0 / rs1.  s[4c + e] is row (e < 2 ? row0
// : row1), key k0 + 8c + 2t + (e & 1).
__device__ __forceinline__ void softmax_tile(
        float (&s)[D128_NS], bool masked, int k0, int S, int causal, int t,
        int row0, int row1, float scale_log2, float& m0, float& m1,
        float& a0, float& a1, float& rs0, float& rs1) {
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int i = 0; i < D128_NS; ++i) {
        if (masked) {
            const int kp = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const int qp = (i & 2) ? row1 : row0;
            if (kp >= S || (causal && kp > qp)) s[i] = NEG;
        }
        if (i & 2) mx1 = fmaxf(mx1, s[i]);
        else mx0 = fmaxf(mx0, s[i]);
    }
    // a row's keys lie in the 4 lanes of one quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_WARP, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_WARP, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_WARP, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_WARP, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    a0 = ex2((m0 - mn0) * scale_log2);
    a1 = ex2((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    const float off0 = -mn0 * scale_log2, off1 = -mn1 * scale_log2;
    rs0 = 0.0f;
    rs1 = 0.0f;
#pragma unroll
    for (int i = 0; i < D128_NS; ++i) {
        const float p = ex2(fmaf(s[i], scale_log2, (i & 2) ? off1 : off0));
        s[i] = p;
        if (i & 2) rs1 += p;
        else rs0 += p;
    }
}

// The earlier tiles' rescale, l (this lane's share; the quad sums last),
// and P rounded to bf16 as the A fragments of P V, pairwise from the score
// accumulator.
__device__ __forceinline__ void rescale_pack(
        float (&acc)[64], const float (&s)[D128_NS],
        uint32_t (&pa)[D128_BK / 16][4], float a0, float a1, float rs0,
        float rs1, float& l0, float& l1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= (i & 2) ? a1 : a0;
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int kk = 0; kk < D128_BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
}

// One item: head bh of batch row bh / H, q rows [q0, q0 + 128), its causal
// key tiles; items run longest first (the q tile axis reversed)
struct Item128 {
    int b, h, q0, n, n_wg;
    __device__ __forceinline__ Item128(int item, int BH, int H, int n_qt,
                                       int S, int causal) {
        const int bh = item % BH;
        b = bh / H;
        h = bh % H;
        q0 = (n_qt - 1 - item / BH) * D128_BQ;
        // its tiles, the same for both warpgroups: up to the diagonal one
        n = causal ? (min(q0 + D128_BQ, S) - 1) / D128_BK + 1
                   : (S + D128_BK - 1) / D128_BK;
        n_wg = q0 + 64 < S ? 2 : 1;                // warpgroups with rows
    }
};

__global__ void __launch_bounds__(D128_THREADS, 1)
flash_tc128_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o, int S, int H,
                   int KV, int BH, int n_qt, float scale_log2, int causal) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
    // Q tiles, O tiles, then stage st's K and V
    const uint32_t sO = base + D128_WG * D128_QTILE;
    const uint32_t sKV = sO + D128_WG * D128_QTILE;
    const uint32_t barQ = sKV + 2 * D128_STAGES * D128_KVTILE;
    const uint32_t barQfree = barQ + 8;
    // full[st] at barQ + 8 (2 + st), empty[st] at barQ + 8 (2 + STAGES + st)
    auto full = [&](int st) { return barQ + 8 * (2 + st); };
    auto empty = [&](int st) { return barQ + 8 * (2 + D128_STAGES + st); };

    const int tid = threadIdx.x;
    const int n_items = BH * n_qt;
    if (tid == 0) {
        mbar_init(barQ, 1);
        mbar_init(barQfree, 4 * D128_WG);            // one arrival a warp
        for (int st = 0; st < D128_STAGES; ++st) {
            mbar_init(full(st), 1);
            mbar_init(empty(st), 4 * D128_WG);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the warpgroup as a value the compiler knows is one across a warp: the
    // branches on it are then uniform, and the consumers' products are
    // issued outside divergent code (measured 10 % faster than tid >> 7
    // with an early return for the producer warp, PERF.md)
    const int wg = __shfl_sync(FULL_WARP, tid >> 7, 0);
    if (wg >= D128_WG) {
        // The producer warp: one thread loads each item's two Q tiles once
        // the consumers are done with the last ones (rows past S arrive as
        // zeros), and keeps the ring of K / V tiles full across items.
        if (tid == 128 * D128_WG) {
            int it = 0;                                  // ring tiles so far
            int local = 0;                               // this block's items
            for (int item = blockIdx.x; item < n_items;
                 item += gridDim.x, ++local) {
                const Item128 w(item, BH, H, n_qt, S, causal);
                const int kvh = w.h / (H / KV);
                if (local > 0) mbar_wait(barQfree, (local - 1) & 1);
                mbar_expect_tx(barQ, D128_WG * D128_QTILE);
                for (int g = 0; g < D128_WG; ++g)
                    for (int c = 0; c < 2; ++c)
                        tma_load(&map_q,
                                 base + g * D128_QTILE + c * D128_BOX_B,
                                 barQ, 64 * c, w.h, w.q0 + 64 * g, w.b);
                for (int j = 0; j < w.n; ++j, ++it) {
                    const int st = it % D128_STAGES;
                    if (it >= D128_STAGES)
                        mbar_wait(empty(st), (it / D128_STAGES - 1) & 1);
                    const uint32_t sK = sKV + 2 * st * D128_KVTILE;
                    mbar_expect_tx(full(st), 2 * D128_KVTILE);
                    for (int c = 0; c < 2; ++c)
                        for (int r = 0; r < D128_BK / 64; ++r) {
                            const uint32_t off =
                                c * D128_KBOX + r * D128_BOX_B;
                            const int s0 = j * D128_BK + 64 * r;
                            tma_load(&map_k, sK + off, full(st), 64 * c, kvh,
                                     s0, w.b);
                            tma_load(&map_v, sK + D128_KVTILE + off, full(st),
                                     64 * c, kvh, s0, w.b);
                        }
                }
            }
        }
    } else {
        const int warp = (tid >> 5) & 3, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;    // fragment row / col pair
        const uint32_t sQ = base + wg * D128_QTILE;
        uint8_t* gO = gbase + (sO - base) + wg * D128_QTILE;
        int it = 0, local = 0;
        for (int item = blockIdx.x; item < n_items;
             item += gridDim.x, ++local) {
            const Item128 w(item, BH, H, n_qt, S, causal);
            mbar_wait(barQ, local & 1);
            if (wg >= w.n_wg) {
                // rows all past S: release Q and every tile as the other reads
                if (lane == 0) mbar_arrive(barQfree);
                for (int j = 0; j < w.n; ++j, ++it) {
                    const int st = it % D128_STAGES;
                    mbar_wait(full(st), (it / D128_STAGES) & 1);
                    if (lane == 0) mbar_arrive(empty(st));
                }
                continue;
            }
            const int row0 = w.q0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;

            // acc[4c + e]: row (e < 2 ? g : g + 8), column 8c + 2t + (e & 1);
            // s the same over keys
            float acc[64], s[D128_NS];
            uint32_t pa[D128_BK / 16][4];
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
            float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;
            float a0, a1, rs0, rs1;

            // tile j: Q K^T, its softmax, then P V, each product waited for
            // before the next: at most the scores and the output are live, and
            // the other warpgroup's products run under this one's softmax
            for (int j = 0; j < w.n; ++j, ++it) {
                const int st = it % D128_STAGES;
                mbar_wait(full(st), (it / D128_STAGES) & 1);
                wgmma_fence();
                qk128(s, sQ, sKV + 2 * st * D128_KVTILE);
                wgmma_commit();
                wgmma_wait_all();
                fence_regs(s);
                if (j + 1 == w.n && lane == 0) mbar_arrive(barQfree);
                // masked where the tile crosses the diagonal of this
                // warpgroup's rows or holds keys past S
                const int k0 = j * D128_BK;
                softmax_tile(s, (causal && k0 + D128_BK - 1 > w.q0 + 64 * wg)
                                    || k0 + D128_BK > S,
                             k0, S, causal, t, row0, row1, scale_log2, m0, m1,
                             a0, a1, rs0, rs1);
                rescale_pack(acc, s, pa, a0, a1, rs0, rs1, l0, l1);
                fence_regs(acc);
                fence_regs(pa);
                wgmma_fence();
                pv128(acc, pa, sKV + (2 * st + 1) * D128_KVTILE);
                wgmma_commit();
                wgmma_wait_all();
                fence_regs(acc);
                fence_regs(pa);
                if (lane == 0) mbar_arrive(empty(st));
            }

            l0 += __shfl_xor_sync(FULL_WARP, l0, 1);
            l0 += __shfl_xor_sync(FULL_WARP, l0, 2);
            l1 += __shfl_xor_sync(FULL_WARP, l1, 1);
            l1 += __shfl_xor_sync(FULL_WARP, l1, 2);
            const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);

            // epilogue: once the last item's stores have read this
            // warpgroup's O tile, O into it in the layout TMA loads write —
            // a row's 16-byte pieces permuted by the 128-byte swizzle,
            // piece ^= row % 8, in each box — then two TMA stores, which
            // drop the rows past S and finish under the next item's work
            if ((tid & 127) == 0) tma_store_wait_read();
            named_sync(1 + wg, 128);
            const int r0 = 16 * warp + g, r1 = r0 + 8;
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                uint8_t* box = gO + (c >> 3) * D128_BOX_B + 4 * t;
                *reinterpret_cast<__nv_bfloat162*>(
                    box + r0 * 128 + (((c & 7) ^ (r0 & 7)) << 4)) =
                    __floats2bfloat162_rn(acc[4 * c] / den0,
                                          acc[4 * c + 1] / den0);
                *reinterpret_cast<__nv_bfloat162*>(
                    box + r1 * 128 + (((c & 7) ^ (r1 & 7)) << 4)) =
                    __floats2bfloat162_rn(acc[4 * c + 2] / den1,
                                          acc[4 * c + 3] / den1);
            }
            fence_proxy_async();
            named_sync(1 + wg, 128);
            if ((tid & 127) == 0) {
                const uint32_t o = sO + wg * D128_QTILE;
                tma_store(&map_o, o, 0, w.h, w.q0 + 64 * wg, w.b);
                tma_store(&map_o, o + D128_BOX_B, 64, w.h, w.q0 + 64 * wg,
                          w.b);
                tma_store_commit();
            }
        }
        if ((tid & 127) == 0) tma_store_wait_read();
    }
}

cudaError_t launch_tc128(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int H, int KV, float scale,
                         int causal, cudaStream_t st) {
    if (reinterpret_cast<uintptr_t>(o) & 15) return cudaErrorMisalignedAddress;
    CUtensorMap mq, mk, mv, mo;
    if (!make_map<64>(&mq, q, B, S, H, 128)
        || !make_map<64>(&mk, k, B, S, KV, 128)
        || !make_map<64>(&mv, v, B, S, KV, 128)
        || !make_map<64>(&mo, o, B, S, H, 128))
        return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        D128_SMEM);
    if (e != cudaSuccess) return e;
    // one block an SM, each walking items blockIdx.x, + gridDim.x, ...
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess
        || (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) != cudaSuccess)
        return e;
    const int n_qt = (S + D128_BQ - 1) / D128_BQ;
    const int n_items = B * H * n_qt;
    flash_tc128_kernel<<<n_items < sms ? n_items : sms, D128_THREADS,
                         D128_SMEM, st>>>(
        mq, mk, mv, mo, S, H, KV, B * H, n_qt, scale * 1.4426950408889634f,
        causal);
    return cudaGetLastError();
}

// --------------------------------------------------------------------------
// bfloat16 at head dim 224: a tile exactly 224 columns wide, 128 q rows a
// block in two warpgroups that share each K / V tile; the warpgroup that
// releases a stage last refills it
// --------------------------------------------------------------------------
// The D = 224 tile plan: the TMA boxes of one [64 rows x 224] tile, each
// {columns, swizzle row bytes} — three 64-column boxes at the 128-byte
// swizzle, then a 32-column box at the 64-byte swizzle; no column is zero
// fill.
constexpr int D224_BOX_COLS[4] = {64, 64, 64, 32};
constexpr int D224_BOX_ROW_B[4] = {128, 128, 128, 64};
static_assert(D224_BOX_COLS[0] + D224_BOX_COLS[1] + D224_BOX_COLS[2]
              + D224_BOX_COLS[3] == 224
              && D224_BOX_COLS[0] * 2 == D224_BOX_ROW_B[0]
              && D224_BOX_COLS[3] * 2 == D224_BOX_ROW_B[3],
              "the D = 224 boxes cover 224 columns, each one swizzle row");
constexpr int D224_WG = 2;                          // consumer warpgroups
constexpr int D224_BQ = 64 * D224_WG;               // q rows a block
constexpr int D224_BK = BK;                         // keys a k tile
constexpr int D224_STAGES = 2;                      // K/V ring depth
// eight warps, two an SM partition: 255 registers a thread for the 112
// output accumulators, 32 scores and 16 P fragments a warpgroup holds (a
// ninth, producer warp would cap them at 168)
constexpr int D224_THREADS = 128 * D224_WG;
constexpr int D224_BOX_A = 64 * D224_BOX_ROW_B[0];  // 8 KB: a 64-column box
constexpr int D224_TILE = 3 * D224_BOX_A + 64 * D224_BOX_ROW_B[3];  // 28 KB
// Q (one tile a warpgroup, reused for the output), the K/V ring, then
// 1 + STAGES mbarriers and STAGES release counts, and alignment: 169 KB,
// one block an SM
constexpr int D224_SMEM = (D224_WG + 2 * D224_STAGES) * D224_TILE + 1024
    + 8 * (1 + D224_STAGES) + 4 * D224_STAGES;
static_assert(D224_SMEM <= 232448, "one block's shared memory");
static_assert(D224_TILE % 1024 == 0, "every box on a swizzle repeat");

// S = Q K^T over the 224 columns: four k16 steps in each 128-byte box, two
// in the 64-byte one, each step's descriptors in its own box's layout
__device__ __forceinline__ void qk224(float (&s)[32], uint32_t sQ,
                                      uint32_t sK) {
    wgmma_ss_n64_first(s, make_desc(sQ, 16, 1024, 1),
                       make_desc(sK, 16, 1024, 1));
#pragma unroll
    for (int kk = 1; kk < 12; ++kk) {
        const uint32_t off = (kk >> 2) * D224_BOX_A + (kk & 3) * 32;
        wgmma_ss_n64(s, make_desc(sQ + off, 16, 1024, 1),
                     make_desc(sK + off, 16, 1024, 1), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
        const uint32_t off = 3 * D224_BOX_A + kk * 32;
        wgmma_ss_n64(s, make_desc(sQ + off, 16, 512, 2),
                     make_desc(sK + off, 16, 512, 2), 1);
    }
}

// O += P V over the 64 keys of one tile: per k16 step, N = 64 on each
// 128-byte box and N = 32 on the 64-byte one, P from registers, V MN-major
__device__ __forceinline__ void pv224(float (&acc)[3][32], float (&acc32)[16],
                                      const uint32_t (&pa)[4][4],
                                      uint32_t sV) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {                // keys 16 kk ..
#pragma unroll
        for (int c = 0; c < 3; ++c)
            wgmma_rs_n64(acc[c], pa[kk],
                         make_desc(sV + c * D224_BOX_A + kk * 16 * 128,
                                   D224_BOX_A, 1024, 1));
        wgmma_rs_n32(acc32, pa[kk],
                     make_desc(sV + 3 * D224_BOX_A + kk * 16 * 64, 4096, 512,
                               2));
    }
}

__global__ void __launch_bounds__(D224_THREADS, 1)
flash_tc224_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_q32,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_k32,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_v32,
                   const __grid_constant__ CUtensorMap map_o,
                   const __grid_constant__ CUtensorMap map_o32, int S, int H,
                   int KV, float scale_log2, int causal) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
    const uint32_t sKV = base + D224_WG * D224_TILE;  // stage st: K, then V
    const uint32_t barQ = sKV + 2 * D224_STAGES * D224_TILE;
    auto full = [&](int st) { return barQ + 8 * (1 + st); };
    // released[st]: releases of stage st so far, n_wg a tile
    int* released = reinterpret_cast<int*>(
        gbase + (barQ + 8 * (1 + D224_STAGES) - base));

    const int tid = threadIdx.x;
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H;
    const int kvh = h / (H / KV);
    const int qt = gridDim.y - 1 - blockIdx.y;      // longest tiles first
    const int q0 = qt * D224_BQ;
    const int n_k_all = (S + D224_BK - 1) / D224_BK;
    const int n_k = causal && 2 * qt + 2 < n_k_all ? 2 * qt + 2 : n_k_all;
    const int n_wg = q0 + 64 < S ? 2 : 1;            // warpgroups with rows

    // K / V tile j into stage j % STAGES, by one thread
    auto load_kv = [&](int j) {
        const int st = j % D224_STAGES;
        const uint32_t sK = sKV + 2 * st * D224_TILE;
        const uint32_t sV = sK + D224_TILE;
        const int s0 = j * D224_BK;
        mbar_expect_tx(full(st), 2 * D224_TILE);
        for (int c = 0; c < 3; ++c) {
            tma_load(&map_k, sK + c * D224_BOX_A, full(st), 64 * c, kvh, s0,
                     b);
            tma_load(&map_v, sV + c * D224_BOX_A, full(st), 64 * c, kvh, s0,
                     b);
        }
        tma_load(&map_k32, sK + 3 * D224_BOX_A, full(st), 192, kvh, s0, b);
        tma_load(&map_v32, sV + 3 * D224_BOX_A, full(st), 192, kvh, s0, b);
    };
    if (tid == 0) {
        mbar_init(barQ, 1);
        for (int st = 0; st < D224_STAGES; ++st) {
            mbar_init(full(st), 1);
            released[st] = 0;
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // both Q tiles (rows past S arrive as zeros) and the first STAGES
    // K / V tiles
    if (tid == 0) {
        mbar_expect_tx(barQ, D224_WG * D224_TILE);
        for (int w = 0; w < D224_WG; ++w) {
            const uint32_t dst = base + w * D224_TILE;
            for (int c = 0; c < 3; ++c)
                tma_load(&map_q, dst + c * D224_BOX_A, barQ, 64 * c, h,
                         q0 + 64 * w, b);
            tma_load(&map_q32, dst + 3 * D224_BOX_A, barQ, 192, h,
                     q0 + 64 * w, b);
        }
        for (int j = 0; j < n_k && j < D224_STAGES; ++j) load_kv(j);
    }

    const int wg = tid >> 7;
    if (wg >= n_wg) return;                          // rows all past S
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;           // fragment row / col pair
    const int diag = 2 * qt + wg;                    // its diagonal tile
    const int n_kw = causal && diag + 1 < n_k_all ? diag + 1 : n_k_all;
    const uint32_t sQ = base + wg * D224_TILE;
    const int row0 = q0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;

    // acc[c][4i + e]: row (e < 2 ? g : g + 8), column 64c + 8i + 2t + (e & 1)
    // for the three 64-column boxes; acc32 the same over columns 192 ..
    float acc[3][32], acc32[16], s[32];
    uint32_t pa[4][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc32[i] = 0.0f;
    float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(barQ, 0);
    // tile j: Q K^T, its softmax, then P V, each product waited for before
    // the next; the other warpgroup's products run under this one's softmax
    for (int j = 0; j < n_kw; ++j) {
        const int st = j % D224_STAGES;
        const uint32_t sK = sKV + 2 * st * D224_TILE;
        mbar_wait(full(st), (j / D224_STAGES) & 1);
        wgmma_fence();
        qk224(s, sQ, sK);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // mask the diagonal / ragged tile, online softmax (m in score units,
        // p = 2^(s * scale_log2 - m * scale_log2)); s[4c + e] is row
        // (e < 2 ? g : g + 8), key 8c + 2t + (e & 1)
        const int k0 = j * D224_BK;
        const bool masked = (causal && j == diag) || k0 + D224_BK > S;
        float mx0 = NEG, mx1 = NEG;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            if (masked) {
                const int kp = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
                const int qp = (i & 2) ? row1 : row0;
                if (kp >= S || (causal && kp > qp)) s[i] = NEG;
            }
            if (i & 2) mx1 = fmaxf(mx1, s[i]);
            else mx0 = fmaxf(mx0, s[i]);
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_WARP, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_WARP, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_WARP, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_WARP, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float a0 = ex2((m0 - mn0) * scale_log2);
        const float a1 = ex2((m1 - mn1) * scale_log2);
        m0 = mn0;
        m1 = mn1;
        const float off0 = -mn0 * scale_log2, off1 = -mn1 * scale_log2;
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const float p = ex2(fmaf(s[i], scale_log2, (i & 2) ? off1 : off0));
            s[i] = p;
            if (i & 2) rs1 += p;
            else rs0 += p;
        }
        l0 = l0 * a0 + rs0;          // this lane's share; the quad sums last
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[c][i] *= (i & 2) ? a1 : a0;
#pragma unroll
        for (int i = 0; i < 16; ++i) acc32[i] *= (i & 2) ? a1 : a0;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
            pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) fence_regs(acc[c]);
        fence_regs(acc32);
        fence_regs(pa);
        wgmma_fence();
        pv224(acc, acc32, pa, sK + D224_TILE);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < 3; ++c) fence_regs(acc[c]);
        fence_regs(acc32);
        fence_regs(pa);
        // stage st is read by this warpgroup; the last of the warpgroups
        // with rows to release it loads tile j + STAGES there (both read
        // every tile before n_k - 1)
        if (j + D224_STAGES < n_k) {
            named_sync(1 + wg, 128);
            if ((tid & 127) == 0
                && atomicAdd(&released[st], 1)
                       == (j / D224_STAGES + 1) * n_wg - 1)
                load_kv(j + D224_STAGES);
        }
    }

    l0 += __shfl_xor_sync(FULL_WARP, l0, 1);
    l0 += __shfl_xor_sync(FULL_WARP, l0, 2);
    l1 += __shfl_xor_sync(FULL_WARP, l1, 1);
    l1 += __shfl_xor_sync(FULL_WARP, l1, 2);
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);

    // epilogue: O into this warpgroup's Q tile (its last reader, Q K^T, is
    // done) in the layout TMA loads write — 16-byte pieces of a row
    // permuted by the swizzle: piece ^= row % 8 in a 128-byte box, ^=
    // (row / 2) % 4 in the 64-byte one — then four TMA stores, which drop
    // the rows past S
    named_sync(1 + wg, 128);
    uint8_t* gQ = gbase + (sQ - base);
    const int r0 = 16 * warp + g, r1 = r0 + 8;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            uint8_t* box = gQ + c * D224_BOX_A + 4 * t;
            *reinterpret_cast<__nv_bfloat162*>(
                box + r0 * 128 + ((i ^ (r0 & 7)) << 4)) =
                __floats2bfloat162_rn(acc[c][4 * i] / den0,
                                      acc[c][4 * i + 1] / den0);
            *reinterpret_cast<__nv_bfloat162*>(
                box + r1 * 128 + ((i ^ (r1 & 7)) << 4)) =
                __floats2bfloat162_rn(acc[c][4 * i + 2] / den1,
                                      acc[c][4 * i + 3] / den1);
        }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        uint8_t* box = gQ + 3 * D224_BOX_A + 4 * t;
        *reinterpret_cast<__nv_bfloat162*>(
            box + r0 * 64 + ((i ^ ((r0 >> 1) & 3)) << 4)) =
            __floats2bfloat162_rn(acc32[4 * i] / den0, acc32[4 * i + 1] / den0);
        *reinterpret_cast<__nv_bfloat162*>(
            box + r1 * 64 + ((i ^ ((r1 >> 1) & 3)) << 4)) =
            __floats2bfloat162_rn(acc32[4 * i + 2] / den1,
                                  acc32[4 * i + 3] / den1);
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if ((tid & 127) == 0) {
        for (int c = 0; c < 3; ++c)
            tma_store(&map_o, sQ + c * D224_BOX_A, 64 * c, h, q0 + 64 * wg, b);
        tma_store(&map_o32, sQ + 3 * D224_BOX_A, 192, h, q0 + 64 * wg, b);
        tma_store_drain();
    }
}

cudaError_t launch_tc224(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int H, int KV, float scale,
                         int causal, cudaStream_t st) {
    if (reinterpret_cast<uintptr_t>(o) & 15) return cudaErrorMisalignedAddress;
    CUtensorMap mq, mq32, mk, mk32, mv, mv32, mo, mo32;
    if (!make_map<64>(&mq, q, B, S, H, 224)
        || !make_map<32>(&mq32, q, B, S, H, 224)
        || !make_map<64>(&mk, k, B, S, KV, 224)
        || !make_map<32>(&mk32, k, B, S, KV, 224)
        || !make_map<64>(&mv, v, B, S, KV, 224)
        || !make_map<32>(&mv32, v, B, S, KV, 224)
        || !make_map<64>(&mo, o, B, S, H, 224)
        || !make_map<32>(&mo32, o, B, S, H, 224))
        return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc224_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        D224_SMEM);
    if (e != cudaSuccess) return e;
    const dim3 grid(B * H, (S + D224_BQ - 1) / D224_BQ);
    flash_tc224_kernel<<<grid, D224_THREADS, D224_SMEM, st>>>(
        mq, mq32, mk, mk32, mv, mv32, mo, mo32, S, H, KV,
        scale * 1.4426950408889634f, causal);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int KV, float scale, int causal,
                      cudaStream_t st) {
    CUtensorMap mq, mk, mv;
    if (!make_map<D>(&mq, q, B, S, H, D) || !make_map<D>(&mk, k, B, S, KV, D)
        || !make_map<D>(&mv, v, B, S, KV, D))
        return cudaErrorInvalidValue;
    constexpr int bytes = tc_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid(B * H, (S + BQ - 1) / BQ);
    flash_tc_kernel<D><<<grid, THREADS, bytes, st>>>(
        mq, mk, mv, static_cast<bf16*>(o), S, H, KV,
        scale * 1.4426950408889634f, causal);
    return cudaGetLastError();
}

// head dims 80, 128 and 224 take designs of their own (flash_tc80_kernel,
// flash_tc128_kernel, flash_tc224_kernel)
template <>
cudaError_t launch_tc<80>(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int H, int KV, float scale,
                          int causal, cudaStream_t st) {
    return launch_tc80(q, k, v, o, B, S, H, KV, scale, causal, st);
}

template <>
cudaError_t launch_tc<128>(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int KV, float scale,
                           int causal, cudaStream_t st) {
    return launch_tc128(q, k, v, o, B, S, H, KV, scale, causal, st);
}

template <>
cudaError_t launch_tc<224>(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int KV, float scale,
                           int causal, cudaStream_t st) {
    return launch_tc224(q, k, v, o, B, S, H, KV, scale, causal, st);
}

cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int KV, int D, float scale,
                     int causal, int dtype, cudaStream_t st) {
#define REPRO_FLASH_CASE(DIM)                                                \
    case DIM:                                                                \
        return dtype == DTYPE_BF16                                           \
            ? launch_tc<DIM>(q, k, v, o, B, S, H, KV, scale, causal, st)     \
            : launch_f32<DIM>(q, k, v, o, B, S, H, KV, scale, causal, st);
    switch (D) {
        REPRO_FLASH_CASE(16)
        REPRO_FLASH_CASE(32)
        REPRO_FLASH_CASE(64)
        REPRO_FLASH_CASE(80)
        REPRO_FLASH_CASE(128)
        REPRO_FLASH_CASE(224)
        default: return cudaErrorInvalidValue;
    }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q, o: [B, S, H, D]; k, v: [B, S, KV, D]; all contiguous, one dtype
// (DTYPE_F32: CUDA cores; DTYPE_BF16: tensor cores, q / k / v 16-byte
// aligned for TMA).  D in {16, 32, 64, 80, 128, 224}, H a multiple of KV.
// Launches
// on `stream`, never synchronises; returns the launch's cudaError_t
// (0 on success).
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int B, int S,
                                        int H, int KV, int D, float scale,
                                        int causal, int dtype, void* stream) {
    if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if ((S + BQ - 1) / BQ > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (dtype != DTYPE_F32 && dtype != DTYPE_BF16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == DTYPE_BF16
        && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
             | reinterpret_cast<uintptr_t>(v)) & 15))
        return static_cast<int>(cudaErrorMisalignedAddress);
    return static_cast<int>(launch_d(q, k, v, o, B, S, H, KV, D, scale,
                                     causal, dtype,
                                     static_cast<cudaStream_t>(stream)));
}

REPRO_EXPORT const char* flash_attention_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
