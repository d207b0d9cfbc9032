// The per-node decision of one synchronous push-relabel Jacobi round,
// shared by K1 (grid_push_decide) and K2 (grid_push_decide_sched).
//
// Replaces `_decide` of the TPU kernels in
// src/repro/kernels/grid_push/kernel.py. The reference feeds the
// neighbour heights in as four precomputed halo planes (`nbr_h`); here the
// node reads them from `h` itself, so that plane never exists in memory.
#pragma once

#include "common.cuh"

// Layout: e, h, cap_src, cap_sink, h_new are (B, H, W); cap is
// (4, B, H, W); delta is (6, B, H, W) over the targets
// [sink, source, UP, DOWN, LEFT, RIGHT]. P = B*H*W is the plane stride,
// n the node's flat index in a plane, (i, j) its grid position.
//
// Candidate heights: sink 0, source n_nodes, neighbour d its height; INF
// where the residual edge is absent. The FIRST minimum in that order wins
// (strict <), so the sink wins and a tie at n_nodes goes to the source,
// exactly as the reference's argmin. An active node (e > 0) pushes
// min(e, cap) toward it if strictly higher, else relabels to h_min + 1
// when h_min < INF.
__device__ __forceinline__ void grid_push_decide_node(
    const float* __restrict__ e, const int* __restrict__ h,
    const float* __restrict__ cap, const float* __restrict__ cap_src,
    const float* __restrict__ cap_sink, int n_nodes, int64_t P, int64_t n,
    int i, int j, int H, int W, int* __restrict__ h_new,
    float* __restrict__ delta) {
  const int idx = i * W + j;
  const int* hb = h + (n - idx);  // this instance's height plane

  const float ct = cap_sink[n];
  int h_min = ct > 0.f ? 0 : REPRO_INF_H;
  int choice = 0;
  float cap_choice = ct;

  const float cs = cap_src[n];
  const int c_src = cs > 0.f ? n_nodes : REPRO_INF_H;
  if (c_src < h_min) { h_min = c_src; choice = 1; cap_choice = cs; }

#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float cd = cap[d * P + n];
    const int c = cd > 0.f ? repro_nbr(hb, d, i, j, idx, H, W) : REPRO_INF_H;
    if (c < h_min) { h_min = c; choice = 2 + d; cap_choice = cd; }
  }

  const float ev = e[n];
  const int hv = h[n];
  const bool active = ev > 0.f;
  const bool push = active && hv > h_min;
  const bool relabel = active && hv <= h_min && h_min < REPRO_INF_H;

  h_new[n] = relabel ? h_min + 1 : hv;
  const float moved = push ? fminf(ev, cap_choice) : 0.f;
#pragma unroll
  for (int p = 0; p < 6; ++p) delta[p * P + n] = p == choice ? moved : 0.f;
}
