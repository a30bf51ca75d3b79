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
//
// Design for Hopper: one thread block per row, f32 like the reference
// kernel, threads strided over the S lanes with a bounds check (no host
// padding), the row's w / floors_eff / pinned held in registers
// (LPT lanes per thread, a template parameter).  A round is one fused pair
// of block reductions (sum of pinned floors, sum of free weights) and a
// compare.  Pinning only ever grows, so the loop stops at the first round
// that pins nothing new (__syncthreads_or): the state is a fixed point from
// there on, which is what the reference's fixed S rounds arrive at.  The
// kernel is bound by bytes (22 B per lane) when rows converge in a few
// rounds; sums are taken in another order than the reference, so parity is
// held to the reference's tolerance (rtol 1e-4, atol capacity * 1e-5).
#include "common.cuh"
#include <math.h>

namespace {

constexpr float EPS = 1e-9f;     // below f32 resolution of capacity: a literal
constexpr int MAX_LPT = 8;
constexpr int MAX_THREADS = 1024;

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
__global__ void alloc_active_set_kernel(const float* __restrict__ psi,
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

    // at most S rounds pin something new, so round S (0-based) changes
    // nothing and `share` below always belongs to the final pinned set
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

}  // namespace

// Launch on `stream`; every pointer is device memory of the current device.
// Rows longer than MAX_LPT * MAX_THREADS = 8192 lanes are refused (the
// wrapper checks first).  Returns the launch's cudaError_t (0 on success);
// never synchronises.
REPRO_EXPORT int alloc_active_set_launch(
        const float* psi, const float* omega, const float* floors,
        const float* capacity, const uint8_t* mask, float* alloc_out,
        uint8_t* feasible_out, uint8_t* pinned_out, int N, int S,
        void* stream) {
    if (N <= 0 || S <= 0 || S > MAX_LPT * MAX_THREADS)
        return static_cast<int>(cudaErrorInvalidValue);
    // up to 256 threads with as few lanes per thread as cover the row;
    // longer rows take 1024 threads
    int threads = ((S + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    if ((S + threads - 1) / threads > MAX_LPT) threads = MAX_THREADS;
    const int lpt = (S + threads - 1) / threads;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(L)                                                      \
    alloc_active_set_kernel<L><<<N, threads, 0, st>>>(                       \
        psi, omega, floors, capacity, mask, alloc_out, feasible_out,         \
        pinned_out, S)
    if (lpt <= 1) REPRO_LAUNCH(1);
    else if (lpt <= 2) REPRO_LAUNCH(2);
    else if (lpt <= 4) REPRO_LAUNCH(4);
    else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
    return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const char* alloc_active_set_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
