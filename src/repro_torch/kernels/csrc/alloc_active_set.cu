// alloc_active_set — the paper's closed-form deadline-aware allocator
// (Eq. 17-19) for a whole fleet: one (node, resource) problem per row.
//
// Replaces the TPU kernel
// src/repro/kernels/alloc_active_set.py:_alloc_kernel (one Pallas grid step
// per node, S padded to 128 lanes, a fixed S-round fori_loop).
//
// Per node row: clamp and mask the inputs, w = sqrt(omega * psi) (Eq. 17),
// floors rescaled to fit when their sum exceeds the capacity, then the
// monotone pinning fixed point: lanes whose proportional share
// w * max(rem, 0) / max(sum of free w, EPS) falls below their floor are
// pinned at the floor and the rest re-share what is left (Eq. 18-19).
// Pinning only ever grows, so a row stops at the first round that pins
// nothing new: the state is a fixed point from there on, which is what the
// reference's fixed S rounds arrive at (ref.alloc_active_set_ref does the
// same).
//
// What bounds it on Hopper: bytes, 18 B a lane (psi, omega, floors f32 and
// mask u8 read, alloc f32 and pinned u8 written), against ~8 operations a
// lane and ~7 a round over the ~3 rounds a row needs — if the loads keep
// coming and the rounds cost few instructions.  A block per row,
// synchronising every round, issued its loads only at its start and spent
// the rest of its life in barrier latency.
//
// Design.  Warp route, rows of up to 1024 lanes: one warp solves one row,
// lane l holding lanes l + 32 i (i < LPT) of it in registers (w and the
// effective floor; a pinned lane is one whose w is 0); both sums of a round
// are __shfl_xor_sync butterflies, so every lane holds the same total with
// no shared memory and no barrier; a round divides once; the row stops by
// __any_sync.  Persistent CTAs (grid and tile size from
// repro_torch/kernels/alloc_active_set.py:alloc_active_set_geometry) walk
// tiles of R consecutive rows: a tile is one contiguous span of each input,
// 16-byte aligned at both ends (R S a multiple of 16).  A producer warp's
// elected lane brings each tile's four spans into a ring of 2-3 shared
// stages (at most 48 KB a CTA, 4 CTAs an SM) with 1-D bulk copies
// (cp.async.bulk, completing on the stage's "full" mbarrier); the consumer
// warps read the stage lane-strided (any S, no bank conflicts), and each
// releases the stage on its "empty" mbarrier after a proxy fence, so the
// producer refills it only once every warp is done with it.  The next
// tiles' bytes are thus in flight while the warps run this tile's rounds;
// each warp loads its rows' capacities a tile ahead.  Outputs go straight
// from registers, coalesced.  The last, partial tile and any geometry whose
// tile cannot fit the ring (stages = 0) take plain loads.  On an H100 the
// rounds' instructions, not the copies, set the time at (16384, 128): plain
// loads of the same tiles run as fast (PERF.md).  Long-row route,
// rows over 1024 lanes: one thread block per row, lanes strided over its
// threads, a round being one fused pair of block reductions (the design
// this file had before).  Everything is f32 like the reference kernel,
// compiled with -fmad=false; sums are taken in another order than the
// reference and a share is w (rem / denom) where it rounds (w rem) / denom,
// so parity is held to its tolerance (rtol 1e-4, atol capacity * 1e-5).
#include "hopper.cuh"
#include <math.h>

namespace {

constexpr float EPS = 1e-9f;     // below f32 resolution of capacity: a literal

// warp route (limits mirrored in alloc_active_set.py)
constexpr int WARP_MAX_S = 1024;            // 32 lanes x 32 slots
constexpr int MAX_STAGES = 3;
constexpr int MAX_CONSUMERS = 8;            // consumer warps per CTA
constexpr int RING_BYTES = 48 * 1024;       // dynamic shared memory per CTA
constexpr int MAX_CTAS_PER_SM = 4;
constexpr int IN_BYTES_PER_LANE = 13;       // 3 x f32 + u8
// block route
constexpr int MAX_LPT = 8;
constexpr int MAX_THREADS = 1024;

constexpr int ROUTE_WARP = 0;
constexpr int ROUTE_BLOCK = 1;

// ---------------------------------------------------------------------------
// warp route
// ---------------------------------------------------------------------------
// sums across the warp; every lane ends with the same bits (each step adds
// the same two values, in either order)
__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(FULL_WARP, a, off);
    return a;
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(FULL_WARP, a, off);
        b += __shfl_xor_sync(FULL_WARP, b, off);
    }
}

// One row by the calling warp.  p, o, f, m point at the row's lane 0, in a
// ring stage or in device memory; lane `lane` handles lanes lane + 32 i.
// A lane is pinned exactly when its weight is 0: w <= 0 pins it from the
// start, and pinning it sets w to 0 (a free lane's w is > 0), so a round's
// free weight is the plain sum of w.  A round divides once, q = rem /
// denom, and a free lane's share is w q (the reference rounds
// (w rem) / denom: an ulp or two apart, inside the tolerance).
template <int LPT>
__device__ __forceinline__ void solve_row(
        const float* p, const float* o, const float* f, const uint8_t* m,
        float cap, int S, int lane, float* __restrict__ alloc_row,
        uint8_t* __restrict__ pinned_row, uint8_t* __restrict__ feasible) {
    float w[LPT], fl[LPT];
    uint32_t resident = 0;
    float floor_sum = 0.0f;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
        const int s = lane + 32 * i;
        float pv = 0.0f, ov = 0.0f, fv = 0.0f;
        uint8_t mv = 0;
        if (s < S) {            // every load issued before any is used
            mv = m[s];
            pv = p[s];
            ov = o[s];
            fv = f[s];
        }
        const bool res = mv != 0;
        pv = res ? fmaxf(pv, 0.0f) : 0.0f;
        ov = res ? fmaxf(ov, 0.0f) : 0.0f;
        fv = res ? fmaxf(fv, 0.0f) : 0.0f;
        w[i] = sqrtf(ov * pv);                                 // Eq. 17
        fl[i] = fv;
        resident |= static_cast<uint32_t>(res) << i;
        floor_sum += fv;
    }
    floor_sum = warp_sum(floor_sum);
    const bool feas = floor_sum <= cap + 1e-6f;
    const float scale = feas ? 1.0f : cap / fmaxf(floor_sum, EPS);
#pragma unroll
    for (int i = 0; i < LPT; ++i) fl[i] *= scale;

    // at most S rounds pin something new, so round S (0-based) changes
    // nothing; q is that of the final pinned set
    float q = 0.0f;
    for (int it = 0; it <= S; ++it) {
        float pin_floor = 0.0f, free_w = 0.0f;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            pin_floor += w[i] > 0.0f ? 0.0f : fl[i];
            free_w += w[i];
        }
        warp_sum2(pin_floor, free_w);
        q = fmaxf(cap - pin_floor, 0.0f) / fmaxf(free_w, EPS);  // Eq. 19
        bool grew = false;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            if (w[i] > 0.0f && w[i] * q < fl[i]) {              // Eq. 18
                w[i] = 0.0f;
                grew = true;
            }
        }
        if (!__any_sync(FULL_WARP, grew)) break;
    }

#pragma unroll
    for (int i = 0; i < LPT; ++i) {
        const int s = lane + 32 * i;
        if (s < S) {
            const bool res = (resident >> i) & 1u;
            const bool pi = !(w[i] > 0.0f);
            alloc_row[s] = res ? (pi ? fl[i] : w[i] * q) : 0.0f;
            pinned_row[s] = (pi && res) ? 1 : 0;
        }
    }
    if (lane == 0) *feasible = feas ? 1 : 0;
}

// up to 4 lanes a thread (rows of <= 128 lanes: 8 consumer warps a CTA),
// registers are held to what lets MAX_CTAS_PER_SM CTAs share an SM, as the
// geometry's grid assumes; wider rows have fewer warps a CTA
template <int LPT>
__global__ void __launch_bounds__((MAX_CONSUMERS + 1) * 32,
                                  LPT <= 4 ? MAX_CTAS_PER_SM : 1)
alloc_warp_kernel(const float* __restrict__ psi,
                  const float* __restrict__ omega,
                  const float* __restrict__ floors,
                  const float* __restrict__ capacity,
                  const uint8_t* __restrict__ mask,
                  float* __restrict__ alloc_out,
                  uint8_t* __restrict__ feasible_out,
                  uint8_t* __restrict__ pinned_out,
                  int N, int S, int R, int stages, int consumers) {
    extern __shared__ __align__(128) uint8_t ring[];
    __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
    __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tiles = (N + R - 1) / R;
    const int staged_tiles = stages ? N / R : 0;      // the full tiles
    const size_t tile_lanes = static_cast<size_t>(R) * S;
    const uint32_t stage_bytes =
        static_cast<uint32_t>(tile_lanes) * IN_BYTES_PER_LANE;
    const uint32_t ring0 = smem_u32(ring);

    if (stages) {
        if (threadIdx.x == 0) {
            for (int s = 0; s < stages; ++s) {
                mbar_init(smem_u32(&full_bar[s]), 1);
                mbar_init(smem_u32(&empty_bar[s]), consumers);
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n"
                         ::: "memory");
        }
        __syncthreads();
    }

    if (warp == consumers) {           // the producer (only when stages > 0)
        if (lane == 0) {
            int j = 0;
            for (int t = blockIdx.x; t < staged_tiles; t += gridDim.x, ++j) {
                const int s = j % stages;
                // every consumer is done with tile j - stages
                if (j >= stages)
                    mbar_wait(smem_u32(&empty_bar[s]), (j / stages - 1) & 1);
                const uint32_t dst = ring0 + s * stage_bytes;
                const uint32_t bar = smem_u32(&full_bar[s]);
                const size_t e0 = static_cast<size_t>(t) * tile_lanes;
                const uint32_t fb = static_cast<uint32_t>(tile_lanes) * 4;
                mbar_expect_tx(bar, stage_bytes);
                bulk_load(dst, psi + e0, fb, bar);
                bulk_load(dst + fb, omega + e0, fb, bar);
                bulk_load(dst + 2 * fb, floors + e0, fb, bar);
                bulk_load(dst + 3 * fb, mask + e0, fb / 4, bar);
            }
        }
        return;
    }

    // lane k holds the capacity of this warp's k-th row of a tile (R / W <=
    // 2 rows), loaded a tile ahead so that no row waits on it
    const auto load_caps = [&](int t) {
        const int n = t * R + warp + lane * consumers;
        return t < tiles && n < min(N, t * R + R) ? capacity[n] : 0.0f;
    };
    float caps_next = load_caps(blockIdx.x);
    int j = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
        const int row0 = t * R;
        const int rows = min(R, N - row0);
        const bool staged = t < staged_tiles;
        const int s = staged ? j % stages : 0;
        const float* sp =
            reinterpret_cast<const float*>(ring + s * stage_bytes);
        const float caps = caps_next;
        caps_next = load_caps(t + gridDim.x);
        for (int r = warp, k = 0; r < rows; r += consumers, ++k) {
            const int n = row0 + r;
            const float cap = __shfl_sync(FULL_WARP, caps, k);
            const size_t row = static_cast<size_t>(n) * S;
            if (staged) {
                mbar_wait(smem_u32(&full_bar[s]), (j / stages) & 1);
                const size_t l = static_cast<size_t>(r) * S;
                solve_row<LPT>(sp + l, sp + tile_lanes + l,
                               sp + 2 * tile_lanes + l,
                               reinterpret_cast<const uint8_t*>(
                                   sp + 3 * tile_lanes) + l,
                               cap, S, lane, alloc_out + row,
                               pinned_out + row, feasible_out + n);
            } else {
                solve_row<LPT>(psi + row, omega + row, floors + row,
                               mask + row, cap, S, lane, alloc_out + row,
                               pinned_out + row, feasible_out + n);
            }
        }
        if (staged) {
            // this warp's reads of the stage come before the bulk copy that
            // refills it
            fence_proxy_async();
            __syncwarp();
            if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));
        }
    }
}

// ---------------------------------------------------------------------------
// block route: rows over WARP_MAX_S lanes, one thread block each
// ---------------------------------------------------------------------------
// Both sums of one round, reduced together; every thread returns the same
// totals (the per-warp partials are added in warp order by every thread).
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float* s_a, float* s_b) {
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_down_sync(FULL_WARP, a, off);
        b += __shfl_down_sync(FULL_WARP, b, off);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        s_a[warp] = a;
        s_b[warp] = b;
    }
    __syncthreads();
    const int n_warps = (blockDim.x + 31) >> 5;
    a = 0.0f;
    b = 0.0f;
    for (int w = 0; w < n_warps; ++w) {
        a += s_a[w];
        b += s_b[w];
    }
}

template <int LPT>
__global__ void alloc_block_kernel(const float* __restrict__ psi,
                                   const float* __restrict__ omega,
                                   const float* __restrict__ floors,
                                   const float* __restrict__ capacity,
                                   const uint8_t* __restrict__ mask,
                                   float* __restrict__ alloc_out,
                                   uint8_t* __restrict__ feasible_out,
                                   uint8_t* __restrict__ pinned_out,
                                   int S) {
    // two buffers: a round's partials stay readable while the next round's
    // are written (the barrier between rounds is the __syncthreads_or)
    __shared__ float s_a[2][MAX_WARPS];
    __shared__ float s_b[2][MAX_WARPS];

    const int n = blockIdx.x;
    const size_t row = static_cast<size_t>(n) * S;
    const float cap = capacity[n];

    float w[LPT], fl[LPT];
    bool resident[LPT], pinned[LPT];
    float floor_sum = 0.0f, unused = 0.0f;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
        const int s = threadIdx.x + i * blockDim.x;
        resident[i] = s < S && mask[row + s] != 0;
        float p = 0.0f, o = 0.0f, f = 0.0f;
        if (resident[i]) {
            p = fmaxf(psi[row + s], 0.0f);
            o = fmaxf(omega[row + s], 0.0f);
            f = fmaxf(floors[row + s], 0.0f);
        }
        w[i] = sqrtf(o * p);                               // Eq. 17
        fl[i] = f;
        pinned[i] = w[i] <= 0.0f;
        floor_sum += f;
    }
    block_sum2(floor_sum, unused, s_a[0], s_b[0]);
    const bool feasible = floor_sum <= cap + 1e-6f;
    const float scale = feasible ? 1.0f : cap / fmaxf(floor_sum, EPS);
#pragma unroll
    for (int i = 0; i < LPT; ++i) fl[i] *= scale;

    float share[LPT];
    for (int it = 0; it <= S; ++it) {
        float pin_floor = 0.0f, free_w = 0.0f;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            pin_floor += pinned[i] ? fl[i] : 0.0f;
            free_w += pinned[i] ? 0.0f : w[i];
        }
        const int buf = (it + 1) & 1;
        block_sum2(pin_floor, free_w, s_a[buf], s_b[buf]);
        const float rem = fmaxf(cap - pin_floor, 0.0f);        // Eq. 19
        const float denom = fmaxf(free_w, EPS);
        int grew = 0;
#pragma unroll
        for (int i = 0; i < LPT; ++i) {
            share[i] = w[i] * rem / denom;                     // Eq. 18
            if (!pinned[i] && share[i] < fl[i]) {
                pinned[i] = true;
                grew = 1;
            }
        }
        if (!__syncthreads_or(grew)) break;
    }

#pragma unroll
    for (int i = 0; i < LPT; ++i) {
        const int s = threadIdx.x + i * blockDim.x;
        if (s < S) {
            alloc_out[row + s] =
                resident[i] ? (pinned[i] ? fl[i] : share[i]) : 0.0f;
            pinned_out[row + s] = (pinned[i] && resident[i]) ? 1 : 0;
        }
    }
    if (threadIdx.x == 0) feasible_out[n] = feasible ? 1 : 0;
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int LPT>
cudaError_t launch_warp(const float* psi, const float* omega,
                        const float* floors, const float* capacity,
                        const uint8_t* mask, float* alloc_out,
                        uint8_t* feasible_out, uint8_t* pinned_out, int N,
                        int S, int R, int stages, int ctas, int warps,
                        cudaStream_t st) {
    // once a device: as much of the SM's L1 / shared split as shared memory,
    // so that the rings of MAX_CTAS_PER_SM CTAs fit one SM (a ring is at
    // most RING_BYTES = 48 KB, which needs no opt-in)
    static uint64_t carved = 0;                 // bit d: done on device d
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64 || !((carved >> dev) & 1u)) {
        e = cudaFuncSetAttribute(
            alloc_warp_kernel<LPT>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
        if (e != cudaSuccess) return e;
        if (dev < 64) carved |= 1ull << dev;
    }
    const int bytes = stages * IN_BYTES_PER_LANE * R * S;
    const int threads = (warps + (stages ? 1 : 0)) * 32;
    alloc_warp_kernel<LPT><<<ctas, threads, bytes, st>>>(
        psi, omega, floors, capacity, mask, alloc_out, feasible_out,
        pinned_out, N, S, R, stages, warps);
    return cudaGetLastError();
}

}  // namespace

// Launch on `stream` with the geometry of
// repro_torch/kernels/alloc_active_set.py:alloc_active_set_geometry; every
// pointer is device memory of the current device.  A geometry the kernel
// cannot run (a row over its route's limit, a ring over RING_BYTES, a tile
// whose spans do not end on 16 bytes, an input not 16-byte aligned when
// staged) is refused with cudaErrorInvalidValue before anything runs.
// Returns the launch's cudaError_t (0 on success); never synchronises.
REPRO_EXPORT int alloc_active_set_launch(
        const float* psi, const float* omega, const float* floors,
        const float* capacity, const uint8_t* mask, float* alloc_out,
        uint8_t* feasible_out, uint8_t* pinned_out, int N, int S, int route,
        int rows, int stages, int ctas, int warps, void* stream) {
    const int bad = static_cast<int>(cudaErrorInvalidValue);
    if (N <= 0 || S <= 0 || ctas <= 0 || warps <= 0) return bad;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (route == ROUTE_BLOCK) {
        const int threads = warps * 32;
        const int lpt = (S + threads - 1) / threads;
        if (threads > MAX_THREADS || lpt > MAX_LPT || ctas != N) return bad;
#define REPRO_LAUNCH(L)                                                      \
        alloc_block_kernel<L><<<N, threads, 0, st>>>(                        \
            psi, omega, floors, capacity, mask, alloc_out, feasible_out,     \
            pinned_out, S)
        if (lpt <= 1) REPRO_LAUNCH(1);
        else if (lpt <= 2) REPRO_LAUNCH(2);
        else if (lpt <= 4) REPRO_LAUNCH(4);
        else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
        return static_cast<int>(cudaGetLastError());
    }
    if (route != ROUTE_WARP || S > WARP_MAX_S || rows <= 0
            || warps > MAX_CONSUMERS || stages < 0 || stages > MAX_STAGES)
        return bad;
    if (stages) {
        if ((static_cast<long long>(rows) * S) % 16 != 0
                || static_cast<long long>(stages) * IN_BYTES_PER_LANE * rows
                   * S > RING_BYTES
                || !aligned16(psi) || !aligned16(omega) || !aligned16(floors)
                || !aligned16(mask))
            return bad;
    }
    const int lpt = (S + 31) / 32;
    cudaError_t e;
#define REPRO_LAUNCH(L)                                                      \
    e = launch_warp<L>(psi, omega, floors, capacity, mask, alloc_out,        \
                       feasible_out, pinned_out, N, S, rows, stages, ctas,   \
                       warps, st)
    if (lpt <= 1) REPRO_LAUNCH(1);
    else if (lpt <= 2) REPRO_LAUNCH(2);
    else if (lpt <= 4) REPRO_LAUNCH(4);
    else if (lpt <= 8) REPRO_LAUNCH(8);
    else if (lpt <= 16) REPRO_LAUNCH(16);
    else REPRO_LAUNCH(32);
#undef REPRO_LAUNCH
    return static_cast<int>(e);
}

REPRO_EXPORT const char* alloc_active_set_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
