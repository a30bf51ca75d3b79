// Helpers shared by the hand-written Hopper kernels of repro_torch.
//
// Every source in this directory is compiled on its own by
// repro_torch/kernels/_build.py into a shared library with a plain C
// interface (no PyTorch headers), so each exports its own launch function
// that returns the cudaError_t of the launch as an int (0 = success).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int MAX_WARPS = 32;          // 1024 threads per block at most
