// K5 frontier for sm_90a: one frontier-expansion sweep of the BFS matching
// phase. Per column j, the keyed minimum (root, then row) over rows i with
// adj[i, j] & root_row[i] < INF & match_row[i] != j; (INF, 0) where no row
// qualifies.
//
// Replaces the TPU kernel `frontier` of
// src/repro/kernels/frontier/kernel.py:71, which streams (256, 512)
// adjacency tiles through VMEM along the sequential row axis of its grid
// and keeps the per-column accumulator resident across it. Blocks on
// Hopper run in no order and carry nothing from one to the next, so here
// the row axis is split over the blocks of a thread-block cluster and
// merged in distributed shared memory: one launch, no scratch array in
// device memory, no atomics.
//
// Bound: device-memory bytes. The function needs the adjacency rows of the
// labeled rows (root < INF) once, 1 B per entry, both per-row labels once
// (8 B per row) and writes 8 B per column. In a matching solve of the
// smoke's 4 x 4096^2 graphs the labeled share of a sweep runs from 2% to
// 96%: 1.77 ms of bytes per solve of 150 sweeps, 0.0118 ms per sweep at
// 3.35 TB/s; at the smoke's standalone input (half the rows labeled) it is
// 0.0101 ms. What the design does about it:
// - A cluster of C blocks owns one instance and one strip of 32 * V
//   columns (V = 16: 512 columns, one 16-byte load per thread and row, so
//   a warp reads a row's 512-byte segment coalesced). Block r of the
//   cluster covers rows [r * R, (r + 1) * R), R = ceil(n_r / C), in
//   chunks of 512 rows, two rows' labels per thread. `launch_geometry`
//   takes C = 8, the portable maximum, and C = 16 (non-portable) where
//   clusters of 8 would leave SMs of the H100's 132 without a block. At
//   the smoke's shape that is 32 clusters of 8 blocks of 256 threads, one
//   chunk each, and an H100 holds 62 such clusters at once: one wave.
//   (Blocks of 16 warps fit 2 to an SM and 30 clusters, clusters of 16
//   fit 28: a second wave, 25-80% more time on the card.)
// - Compaction: a block stages a chunk's labels; a warp ballot per staged
//   row, its popcount and a shuffle scan over the (row, warp) counts list
//   the chunk's labeled rows in shared memory (row, root, match). Warps
//   take rows from that list only: no warp touches an unlabeled row's
//   bytes, and a chunk with no labeled row costs its 4 KB of labels. The
//   next chunk's labels are loaded while this chunk's rows stream.
// - Deep streaming: each lane issues the loads of kUnroll = 8 listed rows
//   (`ld.global.nc.L1::no_allocate`, 16 B each) before it tests any of
//   them: 8 x 512 B in flight per warp, 64 KB per SM at two blocks of 8
//   warps, against the roughly 18 KB per SM that 3.35 TB/s at about 0.7 us
//   of latency asks for.
// - The cross-chunk minimum: a thread keeps its columns' keys in its
//   warp's plane in shared memory over all of its block's rows (a sparse
//   row touches only its edges' keys); the block reduces the planes, and
//   stores each column's minimum into the shared memory of the cluster's
//   block r that owns it, 1/C of the strip each (`map_shared_rank`);
//   after `cluster.sync()` block r takes the minimum over the C blocks in
//   its own shared memory and writes min_root and claim itself. Stores
//   need no round trip, and no block reads another's shared memory after
//   the barrier, so one `cluster.sync()` is enough (a first barrier
//   phase, arrived at on entry and waited on before the stores, makes
//   sure every block of the cluster has started).
// The other way to stream the rows was tried and dropped: a ring of 32
// slots of 512 B in shared memory, filled by a ninth, producer warp with
// one `cp.async.bulk` per row segment and tracked by per-slot `mbarrier`s,
// the eight warps consuming the slots in list order. Timed in turns on an
// H100 (PERF.md section 6), it matched the register pipeline at 3% of the
// rows labeled and took 1.4-1.7x its time at 50% and 95%: each consumer
// warp folds one row per `mbarrier` wait and one producer warp arms and
// issues every copy, where the pipeline waits once per 8 rows and on
// nothing else.
// Where the time goes (tests/torch_smoke_k5_variants.py: its `stamps`,
// `no_rows` and `empty` variants): about 4.8 us whatever the share (launch 1 us, labels, list,
// merge, the cluster barrier), the rows at 83-91% of the HBM rate while
// they stream, and the spread of the blocks' stream times, which the
// cluster barrier waits for.
// Widths that are not a multiple of 16, and an adjacency that is not
// 16-byte aligned, take V = 1 (one byte per thread and row) through the
// same cluster reduction.
//
// Exactness: a candidate is the 64-bit key (root with its sign bit
// flipped) << 32 | row, whose unsigned order is the order of (root, row)
// for any int32 root; every reduction is a plain minimum of keys, so the
// result equals the plain version bit for bit whatever the order.
//
// `launch_geometry` in kernels/frontier/kernel.py is the one owner of the
// launch: the C entry checks that the geometry it is given fits (shared
// memory, cluster size, grid) and launches with it as given.

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;              // warps that take listed rows
constexpr int kThreads = kWarps * 32;
constexpr int kPerThread = 2;          // rows a thread stages per round
constexpr int kChunk = kPerThread * kThreads;   // rows staged per round
static_assert(kPerThread * kWarps <= 32, "one lane per count");
constexpr int kUnroll = 8;             // listed rows in flight per warp
constexpr int kInf = 1 << 30;          // the matching solver's INF
constexpr unsigned long long kNone = ~0ull;
constexpr int kSmemMax = 232448;       // shared memory a block may use

__device__ __forceinline__ unsigned long long key_of(int root, int row) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(root) ^
                                          0x80000000u)
          << 32) |
         static_cast<unsigned>(row);
}

// Calls f(v) for each nonzero byte v of a 64-bit word, lowest first.
template <class F>
__device__ __forceinline__ void each_byte(unsigned long long w, int v0,
                                          F f) {
  while (w) {
    const int bit = __ffsll(static_cast<long long>(w)) - 1;
    f(v0 + (bit >> 3));
    w &= ~(0xffull << (bit & 56));
  }
}

// One row's adjacency bytes of a thread's V columns.
template <int V>
struct Seg;

template <>
struct Seg<16> {
  uint4 w;
  __device__ __forceinline__ void load(const unsigned char* p) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
        : "l"(p));
  }
  __device__ __forceinline__ void clear() { w = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ bool any() const {
    return (w.x | w.y | w.z | w.w) != 0;
  }
  template <class F>
  __device__ __forceinline__ void each_edge(F f) const {
    each_byte((static_cast<unsigned long long>(w.y) << 32) | w.x, 0, f);
    each_byte((static_cast<unsigned long long>(w.w) << 32) | w.z, 8, f);
  }
};

template <>
struct Seg<1> {
  unsigned b;
  __device__ __forceinline__ void load(const unsigned char* p) {
    b = __ldg(p);
  }
  __device__ __forceinline__ void clear() { b = 0; }
  __device__ __forceinline__ bool any() const { return b != 0; }
  template <class F>
  __device__ __forceinline__ void each_edge(F f) const {
    if (b) f(0);
  }
};

// Fold one listed row (e = {row, root, match}) into a thread's keys of
// columns c0 .. c0 + V - 1, which sit at mine[v * 32] in shared memory.
// The adjacency is sparse, so only the row's edges touch the keys.
template <int V>
__device__ __forceinline__ void take(unsigned long long* mine,
                                     const Seg<V>& s, const int4& e,
                                     int c0) {
  if (!s.any()) return;
  const unsigned long long cand = key_of(e.y, e.x);
  const int mv = e.z - c0;              // the row's matched column, local
  s.each_edge([&](int v) {
    if (v != mv) mine[v * 32] = min(mine[v * 32], cand);
  });
}

// Dynamic shared memory: the warps' key planes [kWarps][V][32].
template <int V>
constexpr int smem_of() {
  return kWarps * V * 32 * 8;
}

// Grid (C * strips, B), cluster (C, 1, 1) with C a power of two up to 16:
// cluster `strip` of instance blockIdx.y; its block r covers rows
// [r * rows_per_block, (r + 1) * rows_per_block) of it.
template <int V>
__global__ void __launch_bounds__(kThreads, 4) frontier_cluster(
    const unsigned char* __restrict__ adj, const int* __restrict__ root_row,
    const int* __restrict__ match_row, int* __restrict__ min_root,
    int* __restrict__ claim, int n_r, int n_c, int rows_per_block) {
  extern __shared__ __align__(128) unsigned long long s_key[];
  __shared__ int4 s_list[kChunk];           // the chunk's labeled rows
  __shared__ int s_count[kPerThread][kWarps];   // labeled rows a warp
  __shared__ unsigned long long s_in[32 * V];       // the cluster's minima

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int col0 = (blockIdx.x / C) * 32 * V;
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = col0 + lane * V;           // this thread's first column
  const int row_lo = min(n_r, rank * rows_per_block);
  const int row_hi = min(n_r, row_lo + rows_per_block);
  const int* rr = root_row + static_cast<int64_t>(b) * n_r;
  const int* mr = match_row + static_cast<int64_t>(b) * n_r;
  const unsigned char* a = adj + static_cast<int64_t>(b) * n_r * n_c + c0;
  unsigned long long* mine = s_key + warp * V * 32 + lane;
  // arrive now and wait before the first store into a peer's shared
  // memory: by then every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // the labels of this thread's rows r0 + k * kThreads + tid of a chunk
  int root[kPerThread], match[kPerThread];
  const auto stage = [&](int r0) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int r = r0 + k * kThreads + tid;
      root[k] = kInf;
      if (r < row_hi) {
        root[k] = rr[r];
        match[k] = mr[r];
      }
    }
  };
  stage(row_lo);
  for (int i = tid; i < kWarps * V * 32; i += kThreads) s_key[i] = kNone;

  for (int r0 = row_lo; r0 < row_hi; r0 += kChunk) {
    // list the chunk's labeled rows: a ballot per warp and staged row,
    // then a prefix over the (row, warp) groups
    unsigned bal[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      bal[k] = __ballot_sync(~0u, root[k] < kInf);
      if (lane == 0) s_count[k][warp] = __popc(bal[k]);
    }
    __syncthreads();
    // lane (k, w) of every warp holds group (k, w)'s count; a scan over
    // the lanes gives each group's offset and the total
    const int gk = lane / kWarps, gw = lane % kWarps;
    const int c = gk < kPerThread ? s_count[gk][gw] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += x;
    }
    const int total = __shfl_sync(~0u, incl, 31);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int off = __shfl_sync(~0u, incl - c, k * kWarps + warp);
      if (root[k] < kInf) {
        s_list[off + __popc(bal[k] & ((1u << lane) - 1u))] =
            make_int4(r0 + k * kThreads + tid, root[k], match[k], 0);
      }
    }
    stage(r0 + kChunk);   // in flight while this chunk's rows stream
    __syncthreads();

    if (c0 < n_c) {
      for (int e0 = warp * kUnroll; e0 < total; e0 += kWarps * kUnroll) {
        Seg<V> s[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          if (e0 + j < total) {
            s[j].load(a + static_cast<int64_t>(s_list[e0 + j].x) * n_c);
          } else {
            s[j].clear();
          }
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          if (e0 + j < total) take(mine, s[j], s_list[e0 + j], c0);
        }
      }
    }
    __syncthreads();   // s_list and s_count are rewritten by the next chunk
  }
  if (row_lo == row_hi) __syncthreads();    // the planes' kNone fill

  // the block's minimum of each strip column over the warp planes (plane
  // position p = v * 32 + lane holds strip column lane * V + v), stored
  // into the shared memory of the cluster's block that owns the column:
  // block r owns strip columns [r * share, (r + 1) * share) and holds the
  // C blocks' minima of them in s_in[C][share]
  const int share = 32 * V / C;
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  for (int p = tid; p < 32 * V; p += kThreads) {
    unsigned long long m = s_key[p];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = min(m, s_key[w * 32 * V + p]);
    const int i = (p % 32) * V + p / 32;
    cluster.map_shared_rank(s_in, i / share)[rank * share + i % share] = m;
  }
  cluster.sync();      // every block's minima have arrived; none is read
                       // from another block after this
  for (int j = tid; j < share; j += kThreads) {
    unsigned long long m = s_in[j];
    for (int r = 1; r < C; ++r) m = min(m, s_in[r * share + j]);
    const int col = col0 + rank * share + j;
    if (col < n_c) {
      const int64_t out = static_cast<int64_t>(b) * n_c + col;
      if (m == kNone) {
        min_root[out] = kInf;
        claim[out] = 0;
      } else {
        min_root[out] =
            static_cast<int>(static_cast<unsigned>(m >> 32) ^ 0x80000000u);
        claim[out] = static_cast<int>(m & 0xffffffffu);
      }
    }
  }
}

// The launch configuration of frontier_cluster<V> (attributes set on the
// kernel first); `attr` receives the cluster dimension.
template <int V>
cudaError_t configure(cudaLaunchConfig_t& config, cudaLaunchAttribute& attr,
                      int cluster, int smem_bytes, int grid_x, int grid_y,
                      cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(frontier_cluster<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
  }
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(
        frontier_cluster<V>, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
  }
  config = {};
  config.gridDim = dim3(static_cast<unsigned>(grid_x),
                        static_cast<unsigned>(grid_y), 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  config.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return err;
}

template <int V>
cudaError_t launch(const void* adj, const void* root_row,
                   const void* match_row, void* min_root, void* claim,
                   int n_r, int n_c, int cluster, int rows_per_block,
                   int smem_bytes, int grid_x, int grid_y,
                   cudaStream_t stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const cudaError_t err = configure<V>(config, attr, cluster, smem_bytes,
                                       grid_x, grid_y, stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(
      &config, frontier_cluster<V>, static_cast<const unsigned char*>(adj),
      static_cast<const int*>(root_row), static_cast<const int*>(match_row),
      static_cast<int*>(min_root), static_cast<int*>(claim), n_r, n_c,
      rows_per_block);
}

// Does the geometry fit this build, the shapes and the card?
bool fits(const void* adj, int B, int n_r, int n_c, int vec, int cluster,
          int rows_per_block, int threads, int smem_bytes, int grid_x,
          int grid_y) {
  if (vec == 16) {
    if (n_c % 16 != 0 || reinterpret_cast<uintptr_t>(adj) % 16 != 0 ||
        smem_bytes != smem_of<16>()) {
      return false;
    }
  } else if (vec != 1 || smem_bytes != smem_of<1>()) {
    return false;
  }
  const int64_t strips = (n_c + 32 * vec - 1) / (32 * vec);
  return threads == kThreads && smem_bytes <= kSmemMax && cluster >= 1 && cluster <= 16 &&
         (cluster & (cluster - 1)) == 0 && rows_per_block >= 1 &&
         static_cast<int64_t>(rows_per_block) * cluster >= n_r &&
         grid_x == cluster * strips && grid_y == B && grid_y <= 65535;
}

}  // namespace

// adj (B, n_r, n_c) bool as bytes, root_row / match_row (B, n_r) int32,
// all contiguous; writes min_root / claim (B, n_c) int32. The launch is
// `launch_geometry`'s (kernels/frontier/kernel.py): columns per thread
// (16 or 1), blocks per cluster, rows per block, threads, dynamic shared
// memory and the grid (cluster * strips, B). A geometry that does not fit
// is refused with cudaErrorInvalidValue and nothing is launched.
extern "C" int frontier(const void* adj, const void* root_row,
                        const void* match_row, void* min_root, void* claim,
                        int B, int n_r, int n_c, int vec, int cluster,
                        int rows_per_block, int threads, int smem_bytes,
                        int grid_x, int grid_y, void* stream) {
  if (B > 0 && n_c > 0) {
    if (n_r < 1 || !fits(adj, B, n_r, n_c, vec, cluster, rows_per_block,
                         threads, smem_bytes, grid_x, grid_y)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        vec == 16
            ? launch<16>(adj, root_row, match_row, min_root, claim, n_r, n_c,
                         cluster, rows_per_block, smem_bytes, grid_x, grid_y,
                         s)
            : launch<1>(adj, root_row, match_row, min_root, claim, n_r, n_c,
                        cluster, rows_per_block, smem_bytes, grid_x, grid_y,
                        s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of a geometry the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters: when it is below the
// grid's, the launch runs in more than one wave.
extern "C" int frontier_max_active_clusters(int vec, int cluster,
                                            int smem_bytes, int grid_x,
                                            int grid_y, int* clusters) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err =
      vec == 16 ? configure<16>(config, attr, cluster, smem_bytes, grid_x,
                                grid_y, nullptr)
                : configure<1>(config, attr, cluster, smem_bytes, grid_x,
                               grid_y, nullptr);
  if (err == cudaSuccess) {
    err = vec == 16 ? cudaOccupancyMaxActiveClusters(
                          clusters, frontier_cluster<16>, &config)
                    : cudaOccupancyMaxActiveClusters(
                          clusters, frontier_cluster<1>, &config);
  }
  return static_cast<int>(err);
}
