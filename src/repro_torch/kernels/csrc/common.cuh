// Shared by every kernel library of repro_torch (one .so per .cu file).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Height "infinity" of the grid solver: int32 2**30, as in the reference.
#define REPRO_INF_H (1 << 30)

// Direction order of every (4, ...) capacity plane: UP, DOWN, LEFT, RIGHT.
#define REPRO_UP 0
#define REPRO_DOWN 1
#define REPRO_LEFT 2
#define REPRO_RIGHT 3

// Text of a CUDA error code returned by an entry point of this library.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Value of the (H, W) plane `p` at the neighbour of (i, j) in direction d,
// INF_H outside the grid (the reference's `_nbr_h`). `p` points at the
// plane of the node's own instance; idx = i * W + j.
__device__ __forceinline__ int repro_nbr(const int* __restrict__ p, int d,
                                         int i, int j, int idx, int H,
                                         int W) {
  switch (d) {
    case REPRO_UP:   return i > 0 ? p[idx - W] : REPRO_INF_H;
    case REPRO_DOWN: return i < H - 1 ? p[idx + W] : REPRO_INF_H;
    case REPRO_LEFT: return j > 0 ? p[idx - 1] : REPRO_INF_H;
    default:         return j < W - 1 ? p[idx + 1] : REPRO_INF_H;
  }
}
