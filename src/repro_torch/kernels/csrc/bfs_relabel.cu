// K3 bfs_relabel_sweeps for sm_90a: joint Jacobi min-plus sweeps of the
// height-to-sink plane `dt` and, optionally, the height-via-source plane
// `ds` over residual out-edges.
//
// Replaces the TPU kernel `bfs_relabel_sweeps` of
// src/repro/kernels/bfs_relabel/kernel.py, which keeps a whole (H, W)
// plane per instance in VMEM and runs its SWEEPS sweeps there. At 256^2 one
// int32 plane is 256 KiB, more than the 227 KB of shared memory a block may
// use, so that design does not carry over.
//
// Bound: device-memory bytes. Per call the function must read the four
// caps, both seeds and both planes once and write both planes once: 40 B
// per node, about 42 MB at 4 x 512^2, some 12.5 us at 3.35 TB/s. This
// first design runs ONE launch per sweep over global memory, reading from
// one ping-pong buffer and writing the other, so each sweep moves the 40 B
// again (about 8x the bound at SWEEPS = 8; much of it from L2, which holds
// 50 MB). A shared-memory-resident tiled sweep or a thread-block cluster
// is later work. A device-side `changed` flag is raised when any value
// moves in any sweep, so the host fixpoint driver syncs once per call.
//
// With `with_ds` = 0 the same entry point relaxes `dt` alone: that is the
// sink-only global relabel `bfs_heights` of the grid solver.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// One relaxation of the plane `in` into `out`: min over the node's own
// value, (neighbour + 1) across each open edge (INF across a closed one)
// and the seed, as the reference's `_relax`.
__device__ __forceinline__ bool relax(const float* __restrict__ cap,
                                      const int* __restrict__ seed,
                                      const int* __restrict__ in,
                                      int* __restrict__ out, int64_t P,
                                      int64_t n, int64_t base, int i, int j,
                                      int idx, int H, int W) {
  const int old = in[n];
  int r = old;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int c = cap[d * P + n] > 0.f
                      ? repro_nbr(in + base, d, i, j, idx, H, W) + 1
                      : REPRO_INF_H;
    r = min(r, c);
  }
  r = min(r, seed[n]);
  out[n] = r;
  return r != old;
}

__global__ void __launch_bounds__(kThreads) bfs_relabel_sweep_kernel(
    const float* __restrict__ cap, const int* __restrict__ seed_t,
    const int* __restrict__ seed_s, const int* __restrict__ dt_in,
    const int* __restrict__ ds_in, int* __restrict__ dt_out,
    int* __restrict__ ds_out, int* __restrict__ changed, int B, int H, int W,
    int with_ds) {
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t P = HW * B;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (n >= P) return;
  const int idx = static_cast<int>(n % HW);
  const int64_t base = n - idx;
  const int i = idx / W;
  const int j = idx % W;
  bool moved = relax(cap, seed_t, dt_in, dt_out, P, n, base, i, j, idx, H, W);
  if (with_ds) {
    moved |= relax(cap, seed_s, ds_in, ds_out, P, n, base, i, j, idx, H, W);
  }
  if (moved) *changed = 1;  // every writer stores the same value
}

}  // namespace

// Runs `sweeps` (>= 1) sweeps, one launch each. Sweep 0 reads (dt, ds);
// sweep k writes buffer a if k is even, else buffer b, and reads the
// other; so the result is in a when `sweeps` is odd, in b when even.
// `changed` (one int32) is zeroed first, then raised by any moving value.
extern "C" int bfs_relabel_sweeps(const void* cap, const void* seed_t,
                                  const void* seed_s, const void* dt,
                                  const void* ds, void* dt_a, void* ds_a,
                                  void* dt_b, void* ds_b, void* changed,
                                  int B, int H, int W, int sweeps,
                                  int with_ds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(changed, 0, sizeof(int), s);
  const int64_t P = static_cast<int64_t>(B) * H * W;
  if (P > 0) {
    const unsigned blocks = static_cast<unsigned>((P + kThreads - 1) /
                                                  kThreads);
    const int* t_in = static_cast<const int*>(dt);
    const int* s_in = static_cast<const int*>(ds);
    for (int k = 0; k < sweeps; ++k) {
      int* t_out = static_cast<int*>(k % 2 == 0 ? dt_a : dt_b);
      int* s_out = static_cast<int*>(k % 2 == 0 ? ds_a : ds_b);
      bfs_relabel_sweep_kernel<<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(cap), static_cast<const int*>(seed_t),
          static_cast<const int*>(seed_s), t_in, s_in, t_out, s_out,
          static_cast<int*>(changed), B, H, W, with_ds);
      t_in = t_out;
      s_in = s_out;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
