// K4 bidding for sm_90a: per row of a masked part-reduced cost matrix
// where(mask, INF, c - p_y), the minimum, its first column and the second
// minimum: the push-relabel round's cheapest residual arc and the auction
// round's top-2 bid.
//
// Replaces the TPU kernel `bidding` of src/repro/kernels/bidding/kernel.py,
// which streams (256, 512) cost tiles through VMEM and carries a running
// (min1, arg1, min2) per row block along the sequential column axis of its
// grid. Blocks on Hopper run in no order and carry nothing from one to the
// next, so here one warp owns a whole row and walks all its columns; a
// block holds 8 rows, and the batch axis is a grid dimension (the
// reference vmaps the kernel once per batch axis).
//
// Bound: device-memory bytes. The function reads c (4 B) and mask (1 B)
// per entry and p_y once, and writes 12 B per row: at 8 x 512^2 about
// 10.5 MB, some 3.1 us at 3.35 TB/s, for a few integer ops per entry. Each
// lane reads four consecutive costs and prices with one 16-byte load each
// and their four mask bytes with one 4-byte load, so a warp streams 512 B
// of a cost row per step, coalesced (rows whose width is not a multiple of
// 4 take a scalar path with the same arithmetic).
//
// Exactness: each lane keeps a (min1, arg1, min2) triple over its columns,
// ordered by the key (value, column), and lanes merge by warp shuffles:
// the smaller key wins and the larger min1 folds into min2. That is the
// minimum over every column but the winner's whatever the reduction tree,
// so the result equals the plain version bit for bit. c - p_y wraps as
// int32 arithmetic does in PyTorch.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;          // rows per block, one warp each
constexpr int kInf = 1 << 30;      // the assignment solver's INF

struct Top2 {
  int m1;  // minimum value
  int a1;  // its first column
  int m2;  // minimum over the other columns and INF
};

__device__ __forceinline__ int reduced(int c, int p, unsigned char masked) {
  return masked ? kInf
                : static_cast<int>(static_cast<unsigned>(c) -
                                   static_cast<unsigned>(p));
}

// Fold entry (v, column j) into a triple.
__device__ __forceinline__ void push(Top2& t, int v, int j) {
  if (v < t.m1 || (v == t.m1 && j < t.a1)) {
    t.m2 = min(t.m2, t.m1);
    t.m1 = v;
    t.a1 = j;
  } else {
    t.m2 = min(t.m2, v);
  }
}

// Fold another lane's triple into `t`.
__device__ __forceinline__ void merge(Top2& t, const Top2& o) {
  const bool take = o.m1 < t.m1 || (o.m1 == t.m1 && o.a1 < t.a1);
  t.m2 = min(min(t.m2, o.m2), take ? t.m1 : o.m1);
  if (take) {
    t.m1 = o.m1;
    t.a1 = o.a1;
  }
}

__global__ void __launch_bounds__(kWarps * 32) bidding_kernel(
    const int* __restrict__ c, const int* __restrict__ p_y,
    const unsigned char* __restrict__ mask, int* __restrict__ min1,
    int* __restrict__ arg1, int* __restrict__ min2, int n_r, int n_c,
    int vec) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_r) return;  // the whole warp leaves together
  const int64_t off = (static_cast<int64_t>(b) * n_r + row) * n_c;
  const int* cr = c + off;
  const unsigned char* mr = mask + off;
  const int* p = p_y + static_cast<int64_t>(b) * n_c;

  // a lane that sees no column keeps a key above every real one
  Top2 t{INT_MAX, INT_MAX, kInf};
  if (vec) {
    for (int j = lane * 4; j < n_c; j += 128) {
      const int4 cv = *reinterpret_cast<const int4*>(cr + j);
      const int4 pv = *reinterpret_cast<const int4*>(p + j);
      const uchar4 mv = *reinterpret_cast<const uchar4*>(mr + j);
      push(t, reduced(cv.x, pv.x, mv.x), j);
      push(t, reduced(cv.y, pv.y, mv.y), j + 1);
      push(t, reduced(cv.z, pv.z, mv.z), j + 2);
      push(t, reduced(cv.w, pv.w, mv.w), j + 3);
    }
  } else {
    for (int j = lane; j < n_c; j += 32) {
      push(t, reduced(cr[j], p[j], mr[j]), j);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Top2 u{__shfl_xor_sync(0xffffffffu, t.m1, o),
                 __shfl_xor_sync(0xffffffffu, t.a1, o),
                 __shfl_xor_sync(0xffffffffu, t.m2, o)};
    merge(t, u);
  }
  if (lane == 0) {
    const int64_t r = static_cast<int64_t>(b) * n_r + row;
    min1[r] = t.m1;
    arg1[r] = t.a1;
    min2[r] = t.m2;
  }
}

}  // namespace

// c (B, n_r, n_c) int32, p_y (B, n_c) int32, mask (B, n_r, n_c) bool as
// bytes, all contiguous; writes min1 / arg1 / min2 (B, n_r) int32.
extern "C" int bidding(const void* c, const void* p_y, const void* mask,
                       void* min1, void* arg1, void* min2, int B, int n_r,
                       int n_c, void* stream) {
  if (B > 0 && n_r > 0) {
    if (n_c < 1 || B > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int vec = n_c % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p_y) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(mask) % 4 == 0;
    const dim3 grid(static_cast<unsigned>((n_r + kWarps - 1) / kWarps),
                    static_cast<unsigned>(B));
    bidding_kernel<<<grid, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(c), static_cast<const int*>(p_y),
        static_cast<const unsigned char*>(mask), static_cast<int*>(min1),
        static_cast<int*>(arg1), static_cast<int*>(min2), n_r, n_c, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
