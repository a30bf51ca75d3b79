// event_step — the fused [B, S] lockstep tick of Simulator.run_batch.
//
// Replaces the TPU kernel src/repro/kernels/event_step.py:_event_step_kernel
// (one Pallas grid row per replica, S padded to 128 lanes on the host).
//
// Per replica row b:
//   1. completion scan: cand[s] = avail ? t + (rem_g/alloc_g + rem_c/alloc_c)
//      : +inf, with each division evaluated only where its residual is
//      positive; t_comp = min(cand), sid = FIRST lane attaining it;
//   2. dt = (live && isfinite(min(t_comp, t_ev))) ? min(t_comp, t_ev) - t : 0;
//   3. advance every served head by dt under the GPU-then-CPU stage order.
//
// Design for Hopper: one thread block per row (rows are independent, so the
// grid is simply B), threads strided over the S lanes with a bounds check —
// no host padding.  The row minimum is a (value, lane) reduction ordered by
// value then lane, which is np.argmin's first-index tie-break; an all-+inf
// row therefore yields sid = 0 exactly as the references do.  Everything is
// IEEE-754 double, the file is compiled with -fmad=false so `rem - alloc*tg`
// rounds the product first like numpy, and a stage division is guarded by a
// branch on `rem > 0` so 0/0 is never evaluated.  The kernel is bound by
// bytes (50 B per lane against a handful of double operations), and at the
// sizes the simulator uses by launch latency; it reads each input lane
// twice (scan, then advance) from L1/L2 rather than caching a data-dependent
// number of lanes in registers.
#include "common.cuh"
#include <limits.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

struct Best {
    double v;
    int lane;
};

__device__ __forceinline__ bool before(double v, int lane, const Best& b) {
    return v < b.v || (v == b.v && lane < b.lane);
}

__device__ __forceinline__ double stage_time(double rem, double rate) {
    // a pending stage with zero rate divides to +inf and never wins the min
    return rem > 0.0 ? rem / rate : 0.0;
}

__global__ void __launch_bounds__(THREADS)
event_step_kernel(const double* __restrict__ rem_g,
                  const double* __restrict__ rem_c,
                  const double* __restrict__ alloc_g,
                  const double* __restrict__ alloc_c,
                  const uint8_t* __restrict__ avail,
                  const double* __restrict__ t_vec,
                  const double* __restrict__ t_ev_vec,
                  const uint8_t* __restrict__ live_vec,
                  double* __restrict__ rem_g_out,
                  double* __restrict__ rem_c_out,
                  uint8_t* __restrict__ started_out,
                  double* __restrict__ t_comp_out,
                  int* __restrict__ sid_out,
                  int S) {
    __shared__ double s_val[MAX_WARPS];
    __shared__ int s_lane[MAX_WARPS];

    const int b = blockIdx.x;
    const size_t row = static_cast<size_t>(b) * S;
    const double t = t_vec[b];

    // ---- phase 1: completion scan ------------------------------------ //
    Best best{INFINITY, INT_MAX};
    for (int s = threadIdx.x; s < S; s += THREADS) {
        const double dt_g = stage_time(rem_g[row + s], alloc_g[row + s]);
        const double dt_c = stage_time(rem_c[row + s], alloc_c[row + s]);
        const double cand = avail[row + s] ? t + (dt_g + dt_c) : INFINITY;
        if (before(cand, s, best)) best = Best{cand, s};
    }
    for (int off = 16; off > 0; off >>= 1) {
        const double v = __shfl_down_sync(FULL_WARP, best.v, off);
        const int l = __shfl_down_sync(FULL_WARP, best.lane, off);
        if (before(v, l, best)) best = Best{v, l};
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        s_val[warp] = best.v;
        s_lane[warp] = best.lane;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < THREADS / 32; ++w)
            if (before(s_val[w], s_lane[w], best))
                best = Best{s_val[w], s_lane[w]};
        s_val[0] = best.v;
        s_lane[0] = best.lane;
        t_comp_out[b] = best.v;
        sid_out[b] = best.lane;
    }
    __syncthreads();
    const double t_comp = s_val[0];

    // ---- phase 2: advance to the earlier of (completion, heap head) --- //
    const double t_next = fmin(t_comp, t_ev_vec[b]);
    const double dt = (live_vec[b] && isfinite(t_next)) ? t_next - t : 0.0;

    for (int s = threadIdx.x; s < S; s += THREADS) {
        const double rg = rem_g[row + s];
        const double rc = rem_c[row + s];
        const double ag = alloc_g[row + s];
        const double ac = alloc_c[row + s];
        const bool av = avail[row + s] != 0;

        const bool gpu_need = rg > 0.0;
        const bool run_g = av && gpu_need && ag > 0.0 && dt > 0.0;
        const bool stalled = av && gpu_need && ag <= 0.0;
        const double tg = run_g ? fmin(dt, rg / ag) : 0.0;
        const double rg_new = run_g ? rg - ag * tg : rg;
        const double rem_dt = run_g ? dt - tg : dt;
        const bool cpu_ok = av && !stalled && rg_new <= 0.0 && rem_dt > 0.0
                            && rc > 0.0 && ac > 0.0;
        const double tc = cpu_ok ? fmin(rem_dt, rc / ac) : 0.0;

        rem_g_out[row + s] = rg_new;
        rem_c_out[row + s] = cpu_ok ? rc - ac * tc : rc;
        started_out[row + s] = (run_g || cpu_ok) ? 1 : 0;
    }
}

}  // namespace

// Launch on `stream`; every pointer is device memory of the current device.
// Returns the launch's cudaError_t (0 on success); never synchronises.
REPRO_EXPORT int event_step_launch(
        const double* rem_g, const double* rem_c, const double* alloc_g,
        const double* alloc_c, const uint8_t* avail, const double* t,
        const double* t_ev, const uint8_t* live, double* rem_g_out,
        double* rem_c_out, uint8_t* started_out, double* t_comp_out,
        int* sid_out, int B, int S, void* stream) {
    if (B <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
    event_step_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        rem_g, rem_c, alloc_g, alloc_c, avail, t, t_ev, live, rem_g_out,
        rem_c_out, started_out, t_comp_out, sid_out, S);
    return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const char* event_step_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
