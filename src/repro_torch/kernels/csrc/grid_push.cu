// K1 grid_push_decide and K2 grid_push_decide_sched for sm_90a.
//
// Replace the TPU kernels `grid_push_decide` and `grid_push_decide_sched`
// of src/repro/kernels/grid_push/kernel.py.
//
// Bound: device-memory bytes. Per node the decision reads e, h, the four
// grid caps and the two terminal caps (32 B) and writes h_new and six
// delta planes (28 B), for a handful of integer compares: at 4 x 512^2
// that is about 63 MB, some 19 us at 3.35 TB/s. The design follows: one
// thread per node with neighbouring threads on neighbouring addresses, so
// every plane streams through coalesced loads and stores; the four
// neighbour heights are read from `h` (mostly L1/L2 hits) instead of from
// four extra halo planes, which saves 16 B per node against the TPU
// kernel's inputs.
//
// K2 runs the same decision over a per-instance tile permutation whose
// active tiles (those holding a node with excess) come first, with the same
// decomposition as K1: one thread per node, 256 threads per block,
// neighbouring threads on neighbouring addresses along a tile's rows. The
// grid is (T * ceil(bh * bw / 256), B): each block takes one 256-node chunk
// of the tile at one schedule position, so even one instance of 256^2
// (16 tiles of 64 x 64) gets 256 blocks. The block reads `sched[b, pos]`
// and `n_active[b]` from device memory, so there is no host sync per round.
// Blocks at or past n_active[b] write the identity (h copied, delta 0):
// they skip the cap, terminal and excess reads, 24 of the 60 B per node.
// The permutation covers every tile once, so every output element is
// written exactly once.

#include "grid_push.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) grid_push_decide_kernel(
    const float* __restrict__ e, const int* __restrict__ h,
    const float* __restrict__ cap, const float* __restrict__ cap_src,
    const float* __restrict__ cap_sink, int* __restrict__ h_new,
    float* __restrict__ delta, int n_nodes, int B, int H, int W) {
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t P = HW * B;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (n >= P) return;
  const int idx = static_cast<int>(n % HW);
  grid_push_decide_node(e, h, cap, cap_src, cap_sink, n_nodes, P, n,
                        idx / W, idx % W, H, W, h_new, delta);
}

__global__ void __launch_bounds__(kThreads) grid_push_decide_sched_kernel(
    const float* __restrict__ e, const int* __restrict__ h,
    const float* __restrict__ cap, const float* __restrict__ cap_src,
    const float* __restrict__ cap_sink, const int* __restrict__ sched,
    const int* __restrict__ n_active, int* __restrict__ h_new,
    float* __restrict__ delta, int n_nodes, int B, int H, int W, int T,
    int bh, int bw, int chunks) {
  const int pos = blockIdx.x / chunks;
  const int k = (blockIdx.x % chunks) * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (k >= bh * bw) return;
  const int t = sched[static_cast<int64_t>(b) * T + pos];
  if (t < 0 || t >= T) return;  // not a tile id: nothing to write
  const int ntw = W / bw;
  const int i = (t / ntw) * bh + k / bw;
  const int j = (t % ntw) * bw + k % bw;
  const int64_t P = static_cast<int64_t>(B) * H * W;
  const int64_t n = static_cast<int64_t>(b) * H * W +
                    static_cast<int64_t>(i) * W + j;
  if (pos < n_active[b]) {
    grid_push_decide_node(e, h, cap, cap_src, cap_sink, n_nodes, P, n, i, j,
                          H, W, h_new, delta);
  } else {  // a tile with no active node: one round is the identity
    h_new[n] = h[n];
#pragma unroll
    for (int p = 0; p < 6; ++p) delta[p * P + n] = 0.f;
  }
}

}  // namespace

extern "C" int grid_push_decide(const void* e, const void* h, const void* cap,
                                const void* cap_src, const void* cap_sink,
                                void* h_new, void* delta, int n_nodes, int B,
                                int H, int W, void* stream) {
  const int64_t P = static_cast<int64_t>(B) * H * W;
  if (P > 0) {
    const unsigned blocks = static_cast<unsigned>((P + kThreads - 1) /
                                                  kThreads);
    grid_push_decide_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(e), static_cast<const int*>(h),
        static_cast<const float*>(cap), static_cast<const float*>(cap_src),
        static_cast<const float*>(cap_sink), static_cast<int*>(h_new),
        static_cast<float*>(delta), n_nodes, B, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_push_decide_sched(
    const void* e, const void* h, const void* cap, const void* cap_src,
    const void* cap_sink, const void* sched, const void* n_active,
    void* h_new, void* delta, int n_nodes, int B, int H, int W, int T,
    int bh, int bw, void* stream) {
  if (B > 0 && T > 0) {
    const int chunks = (bh * bw + kThreads - 1) / kThreads;
    const dim3 grid(static_cast<unsigned>(T) * chunks,
                    static_cast<unsigned>(B));
    grid_push_decide_sched_kernel<<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(e), static_cast<const int*>(h),
        static_cast<const float*>(cap), static_cast<const float*>(cap_src),
        static_cast<const float*>(cap_sink), static_cast<const int*>(sched),
        static_cast<const int*>(n_active), static_cast<int*>(h_new),
        static_cast<float*>(delta), n_nodes, B, H, W, T, bh, bw, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
