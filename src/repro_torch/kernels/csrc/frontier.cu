// K5 frontier for sm_90a: one frontier-expansion sweep of the BFS matching
// phase. Per column j, the keyed minimum (root, then row) over rows i with
// adj[i, j] & root_row[i] < INF & match_row[i] != j; (INF, 0) where no row
// qualifies.
//
// Replaces the TPU kernel `frontier` of src/repro/kernels/frontier/kernel.py,
// which streams (256, 512) adjacency tiles through VMEM along the
// sequential row axis of its grid and keeps the per-column accumulator
// resident across it. Blocks on Hopper run in no order, so the rows are
// split into chunks of kChunk: a block covers (instance, row chunk,
// 32 * V columns), and a second small kernel takes the minimum over the
// chunks' partial keys. No atomics: each partial key is written once.
//
// Bound: device-memory bytes. The function needs the adjacency rows of the
// labeled rows (root < INF) once, 1 B per entry, both per-row labels once
// (8 B per row) and writes 8 B per column: at most about 67 MB at
// 4 x 4096^2, some 20 us at 3.35 TB/s, less where few rows are labeled. A
// thread owns V = 16 consecutive columns and reads them with one 16-byte
// load per row, so a warp streams 512 B of a row, coalesced; the eight
// warps of a block take every eighth row of the chunk. The labels of the
// chunk's rows are staged in shared memory once, and a row whose root is
// INF is skipped by its whole warp without touching its adjacency bytes.
// Widths that are not a multiple of 16 take V = 1.
//
// Exactness: a candidate is the 64-bit key (root with its sign bit
// flipped) << 32 | row, whose unsigned order is the order of (root, row)
// for any int32 root; every reduction is a plain minimum of keys, so the
// result equals the plain version bit for bit whatever the order.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 256;            // rows per block
constexpr int kInf = 1 << 30;          // the matching solver's INF
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ unsigned long long key_of(int root, int row) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(root) ^
                                          0x80000000u)
          << 32) |
         static_cast<unsigned>(row);
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32) frontier_partial_kernel(
    const unsigned char* __restrict__ adj, const int* __restrict__ root_row,
    const int* __restrict__ match_row, unsigned long long* __restrict__ part,
    int n_r, int n_c, int n_chunks) {
  __shared__ int s_root[kChunk];
  __shared__ int s_match[kChunk];
  // s_key[w][v][lane]: warp w's key of column col0 + lane * V + v
  __shared__ unsigned long long s_key[kWarps][V][32];
  const int b = blockIdx.z;
  const int chunk = blockIdx.y;
  const int col0 = blockIdx.x * 32 * V;
  const int r0 = chunk * kChunk;
  const int rows = min(kChunk, n_r - r0);
  const int64_t rb = static_cast<int64_t>(b) * n_r + r0;
  for (int k = threadIdx.x; k < rows; k += blockDim.x) {
    s_root[k] = root_row[rb + k];
    s_match[k] = match_row[rb + k];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = col0 + lane * V;        // this thread's first column
  unsigned long long key[V];
#pragma unroll
  for (int v = 0; v < V; ++v) key[v] = kNone;
  if (c0 < n_c) {
    const unsigned char* a = adj + rb * n_c + c0;
    for (int k = warp; k < rows; k += kWarps) {
      const int root = s_root[k];
      if (root >= kInf) continue;      // unlabeled: never a candidate
      const int match = s_match[k];
      const unsigned long long cand = key_of(root, r0 + k);
      const unsigned char* ar = a + static_cast<int64_t>(k) * n_c;
      if constexpr (V == 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(ar);
        if ((w.x | w.y | w.z | w.w) == 0) continue;
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int v = 4 * q + s;
            if (((words[q] >> (8 * s)) & 0xffu) && match != c0 + v) {
              key[v] = min(key[v], cand);
            }
          }
        }
      } else {
        if (ar[0] && match != c0) key[0] = min(key[0], cand);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) s_key[warp][v][lane] = key[v];
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * V; i += blockDim.x) {
    const int v = i / 32;
    const int l = i % 32;
    const int col = col0 + l * V + v;
    if (col >= n_c) continue;
    unsigned long long m = s_key[0][v][l];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = min(m, s_key[w][v][l]);
    part[(static_cast<int64_t>(b) * n_chunks + chunk) * n_c + col] = m;
  }
}

__global__ void frontier_final_kernel(
    const unsigned long long* __restrict__ part, int* __restrict__ min_root,
    int* __restrict__ claim, int B, int n_c, int n_chunks) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * n_c) return;
  const int64_t b = idx / n_c;
  const int64_t col = idx % n_c;
  unsigned long long m = kNone;
  for (int k = 0; k < n_chunks; ++k) {
    m = min(m, part[(b * n_chunks + k) * n_c + col]);
  }
  if (m == kNone) {
    min_root[idx] = kInf;
    claim[idx] = 0;
  } else {
    min_root[idx] = static_cast<int>(static_cast<unsigned>(m >> 32) ^
                                     0x80000000u);
    claim[idx] = static_cast<int>(m & 0xffffffffu);
  }
}

}  // namespace

// Rows per chunk: the caller sizes `part` as (B, n_chunks, n_c) uint64
// with n_chunks = ceil(n_r / frontier_chunk_rows()).
extern "C" int frontier_chunk_rows() { return kChunk; }

// adj (B, n_r, n_c) bool as bytes, root_row / match_row (B, n_r) int32,
// all contiguous; writes min_root / claim (B, n_c) int32, using `part` as
// scratch.
extern "C" int frontier(const void* adj, const void* root_row,
                        const void* match_row, void* part, void* min_root,
                        void* claim, int B, int n_r, int n_c, int n_chunks,
                        void* stream) {
  if (B > 0 && n_c > 0) {
    if (n_r < 1 || n_chunks != (n_r + kChunk - 1) / kChunk ||
        n_chunks > 65535 || B > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned char* a = static_cast<const unsigned char*>(adj);
    const int* r = static_cast<const int*>(root_row);
    const int* m = static_cast<const int*>(match_row);
    unsigned long long* p = static_cast<unsigned long long*>(part);
    if (n_c % 16 == 0 && reinterpret_cast<uintptr_t>(adj) % 16 == 0) {
      const dim3 grid(static_cast<unsigned>(n_c / 512 + (n_c % 512 != 0)),
                      static_cast<unsigned>(n_chunks),
                      static_cast<unsigned>(B));
      frontier_partial_kernel<16><<<grid, kWarps * 32, 0, s>>>(
          a, r, m, p, n_r, n_c, n_chunks);
    } else {
      const dim3 grid(static_cast<unsigned>((n_c + 31) / 32),
                      static_cast<unsigned>(n_chunks),
                      static_cast<unsigned>(B));
      frontier_partial_kernel<1><<<grid, kWarps * 32, 0, s>>>(
          a, r, m, p, n_r, n_c, n_chunks);
    }
    const int64_t total = static_cast<int64_t>(B) * n_c;
    frontier_final_kernel<<<static_cast<unsigned>((total + 255) / 256), 256,
                            0, s>>>(p, static_cast<int*>(min_root),
                                    static_cast<int*>(claim), B, n_c,
                                    n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
