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
// Design for Hopper.  The kernel is bound by bytes (50 B per lane against a
// handful of double operations) and, at the simulator's sizes, by latency:
// a row of 1440 lanes is a few microseconds of dependent loads for one
// block.  So each row is split across a thread-block cluster of c <= 8 CTAs
// (cudaLaunchKernelEx with a cluster dimension; c and the CTA width come
// from repro_torch/kernels/event_step.py:event_step_geometry, so that at
// [32, 1440] the grid is 32 clusters of 4 CTAs of 384 threads on the 132
// SMs).  Each thread owns ONE lane of the row, CTA r covering lanes
// [r T, (r + 1) T): its five inputs are loaded before anything waits on
// them and stay in registers across both phases, and its two stage times
// are divided once and reused by the advance (run_g implies rem_g > 0 and
// cpu_ok implies rem_c > 0, so the operands, and the bits, are the same).
// A row longer than the cluster's c T threads walks the rest with a strided
// loop that reads its lanes again in phase 2.  The row minimum is a (value,
// lane) reduction ordered by value then lane — np.argmin's first-index
// tie-break, so an all-+inf row yields sid = 0 as the references do: warp
// shuffles, then the CTA's warps through shared memory and one more warp of
// shuffles, then, after a cluster barrier, lane r of every CTA's first warp
// reads CTA r's partial from its shared memory (DSMEM) and the same shuffles
// give every CTA the same minimum; rank 0 writes t_comp and sid.  A second
// cluster barrier, waited on only at the end, keeps each CTA's partial alive
// until its peers have read it.  Everything is IEEE-754
// double, the file is compiled with -fmad=false so `rem - alloc*tg` rounds
// the product first like numpy, and a stage division is guarded by a branch
// on `rem > 0` so 0/0 is never evaluated.
#include "common.cuh"
#include <cooperative_groups.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 8;       // the portable cluster size

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

// the minimum of a warp's pairs, in lane 0
__device__ __forceinline__ Best warp_min(Best best) {
    for (int off = 16; off > 0; off >>= 1) {
        const double v = __shfl_down_sync(FULL_WARP, best.v, off);
        const int l = __shfl_down_sync(FULL_WARP, best.lane, off);
        if (before(v, l, best)) best = Best{v, l};
    }
    return best;
}

// The advance of one lane, given its stage times dt_g = stage_time(rg, ag)
// and dt_c = stage_time(rc, ac).
__device__ __forceinline__ void advance_lane(
        double rg, double rc, double ag, double ac, bool av, double dt_g,
        double dt_c, double dt, double* rg_out, double* rc_out,
        uint8_t* started_out) {
    const bool gpu_need = rg > 0.0;
    const bool run_g = av && gpu_need && ag > 0.0 && dt > 0.0;
    const bool stalled = av && gpu_need && ag <= 0.0;
    const double tg = run_g ? fmin(dt, dt_g) : 0.0;
    const double rg_new = run_g ? rg - ag * tg : rg;
    const double rem_dt = run_g ? dt - tg : dt;
    const bool cpu_ok = av && !stalled && rg_new <= 0.0 && rem_dt > 0.0
                        && rc > 0.0 && ac > 0.0;
    const double tc = cpu_ok ? fmin(rem_dt, dt_c) : 0.0;
    *rg_out = rg_new;
    *rc_out = cpu_ok ? rc - ac * tc : rc;
    *started_out = (run_g || cpu_ok) ? 1 : 0;
}

__global__ void __launch_bounds__(MAX_THREADS)
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
    __shared__ Best s_part;               // this CTA's minimum, read by peers
    __shared__ double s_tcomp;

    cg::cluster_group cluster = cg::this_cluster();
    const int c = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int T = blockDim.x;
    const int tid = threadIdx.x;
    const int b = blockIdx.x / c;
    const size_t row = static_cast<size_t>(b) * S;

    // ---- every load of this thread's lane first ---------------------- //
    const int lane = rank * T + tid;
    const bool mine = lane < S;
    double rg = 0.0, rc = 0.0, ag = 0.0, ac = 0.0;
    bool av = false;
    if (mine) {
        rg = rem_g[row + lane];
        rc = rem_c[row + lane];
        ag = alloc_g[row + lane];
        ac = alloc_c[row + lane];
        av = avail[row + lane] != 0;
    }
    const double t = t_vec[b];
    const double t_ev = t_ev_vec[b];
    const bool live = live_vec[b] != 0;

    // ---- phase 1: completion scan ------------------------------------ //
    const double dt_g = stage_time(rg, ag);
    const double dt_c = stage_time(rc, ac);
    Best best{INFINITY, INT_MAX};
    if (mine) best = Best{av ? t + (dt_g + dt_c) : INFINITY, lane};
    const int stride = c * T;
    for (int s = stride + lane; s < S; s += stride) {
        const double cand = avail[row + s]
            ? t + (stage_time(rem_g[row + s], alloc_g[row + s])
                   + stage_time(rem_c[row + s], alloc_c[row + s]))
            : INFINITY;
        if (before(cand, s, best)) best = Best{cand, s};
    }
    // (value, lane) pairs are totally ordered (lanes differ), so the
    // minimum does not depend on the order the reductions take
    best = warp_min(best);
    const int warp = tid >> 5, wl = tid & 31;
    if (wl == 0) {
        s_val[warp] = best.v;
        s_lane[warp] = best.lane;
    }
    __syncthreads();
    if (warp == 0) {
        best = wl < T / 32 ? Best{s_val[wl], s_lane[wl]}
                           : Best{INFINITY, INT_MAX};
        best = warp_min(best);
        if (wl == 0) s_part = best;
    }
    cluster.sync();                       // every CTA's partial is written
    if (warp == 0) {                      // lane r reads CTA r's partial
        Best row_best = wl < c ? *cluster.map_shared_rank(&s_part, wl)
                               : Best{INFINITY, INT_MAX};
        row_best = warp_min(row_best);
        if (wl == 0) {
            s_tcomp = row_best.v;
            if (rank == 0) {
                t_comp_out[b] = row_best.v;
                sid_out[b] = row_best.lane;
            }
        }
    }
    // peers may leave once this CTA has read them: arrive now, wait at exit
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    __syncthreads();
    const double t_comp = s_tcomp;

    // ---- phase 2: advance to the earlier of (completion, heap head) --- //
    const double t_next = fmin(t_comp, t_ev);
    const double dt = (live && isfinite(t_next)) ? t_next - t : 0.0;
    if (mine)
        advance_lane(rg, rc, ag, ac, av, dt_g, dt_c, dt, &rem_g_out[row + lane],
                     &rem_c_out[row + lane], &started_out[row + lane]);
    for (int s = stride + lane; s < S; s += stride) {
        const double rg2 = rem_g[row + s], rc2 = rem_c[row + s];
        const double ag2 = alloc_g[row + s], ac2 = alloc_c[row + s];
        advance_lane(rg2, rc2, ag2, ac2, avail[row + s] != 0,
                     stage_time(rg2, ag2), stage_time(rc2, ac2), dt,
                     &rem_g_out[row + s], &rem_c_out[row + s],
                     &started_out[row + s]);
    }
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

}  // namespace

// Launch on `stream`; every pointer is device memory of the current device.
// `cluster` CTAs of `threads` threads share each row (1 <= cluster <= 8,
// threads a multiple of 32 up to 1024).  Returns the launch's cudaError_t
// (0 on success); never synchronises.
REPRO_EXPORT int event_step_launch(
        const double* rem_g, const double* rem_c, const double* alloc_g,
        const double* alloc_c, const uint8_t* avail, const double* t,
        const double* t_ev, const uint8_t* live, double* rem_g_out,
        double* rem_c_out, uint8_t* started_out, double* t_comp_out,
        int* sid_out, int B, int S, int cluster, int threads, void* stream) {
    if (B <= 0 || S <= 0 || cluster < 1 || cluster > MAX_CLUSTER
            || threads < 32 || threads > MAX_THREADS || threads % 32 != 0
            || static_cast<long long>(B) * cluster > INT_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, event_step_kernel, rem_g, rem_c, alloc_g, alloc_c, avail, t,
        t_ev, live, rem_g_out, rem_c_out, started_out, t_comp_out, sid_out,
        S);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const char* event_step_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
