// K4 bidding for sm_90a: per row of a masked part-reduced cost matrix
// where(mask, INF, c - p_y), the minimum, its first column and the second
// minimum: the push-relabel round's cheapest residual arc and the auction
// round's top-2 bid.
//
// Replaces the TPU kernel `bidding` of src/repro/kernels/bidding/kernel.py:67,
// which streams (256, 512) cost tiles through VMEM and carries a running
// (min1, arg1, min2) per row block along the sequential column axis of its
// grid. Blocks on Hopper run in no order and carry nothing from one to the
// next, so here one warp folds a whole row: block k of a 1-D grid takes
// rows 8k .. 8k + 7 of the flattened B * n_r rows, one per warp, and a
// warp finds its row's instance (and price row) itself, so a block may
// cross instances and B has no grid limit.
//
// Bound: device-memory bytes. The function reads c (4 B) and mask (1 B)
// per entry and p_y once, and writes 12 B per row: at the assignment
// path's 8 x 512^2 about 10.5 MB, some 3.1 us at 3.35 TB/s, for a few
// integer ops per entry. What the design does about it:
// - Coalesced 16-byte loads: a lane owns 4 consecutive columns of each
//   128-column chunk (one 16-byte cost load, one 4-byte mask load, one
//   16-byte price load), so a warp reads 512 B of costs and 128 B of mask
//   per chunk, contiguous.
// - Depth: a lane issues the loads of kChunks = 2 chunks before it folds
//   either, so no fold waits on the next chunk's round trip; cost and
//   mask bypass L1 (`ld.global.nc.L1::no_allocate`), read once; prices
//   go through L1, which the block's 8 warps share.
// - Occupancy: 8-warp blocks at under 64 registers; the smoke's 512
//   blocks are one wave of 4 blocks an SM.
// Measured on an H100 (PERF.md section 6, tests/torch_smoke_k4_variants.py):
// with the L2 flushed by writes, the call also pays for writing back the
// flush's dirty lines it evicts, and the first design already ran near
// that floor at 8 x 512^2; this one matches it there and wins where a
// row's round trips are exposed (one 512^2 instance, 2048-wide rows). Two
// other designs were timed and dropped: a persistent block per SM fed by
// `cp.async.bulk` copies of its whole row range into shared memory, and
// one staging those rows in registers; both took 1.3-1.4x as long.
// Widths that are not a multiple of 4, and tensors off the vector loads'
// alignment, take a scalar path with the same arithmetic (a lane owns
// columns lane, lane + 32, ...).
//
// Exactness: each lane keeps a (min1, arg1, min2) triple over its columns,
// ordered by the key (value, column), and lanes merge by warp shuffles:
// the smaller key wins and the larger min1 folds into min2. That is the
// minimum over every column but the winner's whatever the order of the
// folds and the shape of the reduction tree, so the result equals the
// plain version bit for bit. c - p_y wraps as int32 arithmetic does in
// PyTorch.
//
// `launch_geometry` in kernels/bidding/kernel.py is the one owner of the
// launch (path, rows per block, blocks, threads); the C entry checks that
// what it is given fits and launches it as given.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;            // rows per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;          // columns per warp and 16-byte load
constexpr int kChunks = 2;           // chunks whose loads a lane issues ahead
constexpr int kInf = 1 << 30;        // the assignment solver's INF

struct Top2 {
  int m1;  // minimum value
  int a1;  // its first column
  int m2;  // minimum over the other columns and INF
};

__device__ __forceinline__ int reduced(int c, int p, unsigned masked) {
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

// Read-once loads: cost and mask are not read again, so they skip L1.
__device__ __forceinline__ int4 load_once(const int* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned load_once(const unsigned char* p) {
  unsigned v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kThreads) bidding_kernel(
    const int* __restrict__ c, const int* __restrict__ p_y,
    const unsigned char* __restrict__ mask, int* __restrict__ min1,
    int* __restrict__ arg1, int* __restrict__ min2, int64_t rows, int n_r,
    int n_c, int vec) {
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp leaves together
  const int* cr = c + r * n_c;
  const unsigned char* mr = mask + r * n_c;
  // the row's instance; a 32-bit division where the rows allow one
  const int64_t b = rows <= INT_MAX ? static_cast<int>(r) / n_r : r / n_r;
  const int* p = p_y + b * n_c;

  // a lane that sees no column keeps a key above every real one
  Top2 t{INT_MAX, INT_MAX, kInf};
  if (vec) {
    for (int j0 = 4 * lane; j0 < n_c; j0 += kChunks * kChunk) {
      int4 cv[kChunks], pv[kChunks];
      unsigned mv[kChunks];
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int j = j0 + k * kChunk;
        if (j < n_c) {
          cv[k] = load_once(cr + j);
          mv[k] = load_once(mr + j);
        }
      }
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int j = j0 + k * kChunk;
        if (j < n_c) pv[k] = __ldg(reinterpret_cast<const int4*>(p + j));
      }
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int j = j0 + k * kChunk;
        if (j < n_c) {
          push(t, reduced(cv[k].x, pv[k].x, mv[k] & 0xffu), j);
          push(t, reduced(cv[k].y, pv[k].y, (mv[k] >> 8) & 0xffu), j + 1);
          push(t, reduced(cv[k].z, pv[k].z, (mv[k] >> 16) & 0xffu), j + 2);
          push(t, reduced(cv[k].w, pv[k].w, mv[k] >> 24), j + 3);
        }
      }
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
    min1[r] = t.m1;
    arg1[r] = t.a1;
    min2[r] = t.m2;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Does the geometry fit this build and the shapes?
bool fits(const void* c, const void* p_y, const void* mask, int B, int n_r,
          int n_c, int vec, int rows_per_block, int blocks, int threads) {
  const int64_t rows = static_cast<int64_t>(B) * n_r;
  if (threads != kThreads || rows_per_block != kWarps || blocks < 1 ||
      static_cast<int64_t>(blocks) * kWarps < rows ||
      static_cast<int64_t>(blocks - 1) * kWarps >= rows) {
    return false;
  }
  return vec == 0 || (vec == 1 && n_c % 4 == 0 && aligned(c, 16) &&
                      aligned(p_y, 16) && aligned(mask, 4));
}

}  // namespace

// c (B, n_r, n_c) int32, p_y (B, n_c) int32, mask (B, n_r, n_c) bool as
// bytes, all contiguous; writes min1 / arg1 / min2 (B, n_r) int32. The
// launch is `launch_geometry`'s (kernels/bidding/kernel.py): the path
// (1 vector, 0 scalar), rows per block, blocks and threads. A geometry
// that does not fit is refused with cudaErrorInvalidValue and nothing is
// launched.
extern "C" int bidding(const void* c, const void* p_y, const void* mask,
                       void* min1, void* arg1, void* min2, int B, int n_r,
                       int n_c, int vec, int rows_per_block, int blocks,
                       int threads, void* stream) {
  if (B < 1 || n_r < 1 || n_c < 1 ||
      !fits(c, p_y, mask, B, n_r, n_c, vec, rows_per_block, blocks,
            threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bidding_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(c), static_cast<const int*>(p_y),
      static_cast<const unsigned char*>(mask), static_cast<int*>(min1),
      static_cast<int*>(arg1), static_cast<int*>(min2),
      static_cast<int64_t>(B) * n_r, n_r, n_c, vec);
  return static_cast<int>(cudaGetLastError());
}
