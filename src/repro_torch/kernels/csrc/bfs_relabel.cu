// K3 bfs_relabel_sweeps for sm_90a: joint Jacobi min-plus sweeps of the
// height-to-sink plane `dt` and, optionally, the height-via-source plane
// `ds` over residual out-edges.
//
// Replaces the TPU kernel `bfs_relabel_sweeps` of
// src/repro/kernels/bfs_relabel/kernel.py, which keeps a whole (H, W)
// plane per instance in VMEM and runs its SWEEPS sweeps there. At 256^2 one
// int32 plane is 256 KiB, more than the 227 KB of shared memory a block may
// use, so that design does not carry over as it is.
//
// Bound: device-memory bytes. Per call the function must read the four
// caps, both seeds and both planes once and write both planes once: 40 B
// per node (28 B with `ds` off), about 42 MB at 4 x 512^2, some 12.5 us at
// 3.35 TB/s.
//
// Design: temporal blocking, all sweeps of a launch in shared memory. One
// block owns a tile_h x tile_w output tile of one instance and loads the
// window of (tile_h + 2 kHalo) x (tile_w + 2 kHalo) nodes around it, so a
// call reads each byte once plus the halo's share (partly L2 hits) and
// writes each output once. It then runs up to kHalo exact Jacobi sweeps
// between two shared-memory buffers per plane, one __syncthreads() per
// sweep. A node at distance d from the window's edge is exact after s
// sweeps whenever d >= s: its value depends only on nodes at distance < s
// from it. The owned tile sits kHalo deep, so it equals kHalo global
// sweeps. What a node in the window's outer ring reads from beyond the
// ring is garbage and never reaches the tile: the row above or below is
// clamped to the ring's own row, and a horizontal shuffle there may bring
// a node of the neighbouring window row (a warp spans row ends). Nodes
// outside the grid are INF with every edge closed, which is what
// `repro_nbr` and the reference's shift give.
//
// Each thread owns 4 consecutive nodes of one window row; a block is a
// whole number of warps (the C entry refuses other shapes). It loads them
// with 16-byte loads (when W % 4 == 0; else one by one), keeps their values
// and their four edge weights in registers, takes the horizontal
// neighbours from the neighbouring lanes by shuffles and reads shared
// memory for the rows above and below (one 16-byte load each) and, in the
// first and last lane of a warp, for the node beyond its ends. It stores
// its new row as one 16-byte vector per sweep, and writes its owned nodes
// straight from registers. Seeds go through the second buffer and are read
// in the first sweep only: afterwards every value is at or below its seed.
//
// Each relaxation step is one DPX add-min (`__viaddmin_s32`, one Hopper
// instruction): min(x, nbr + w), with w = 1 across an open edge (cap > 0)
// and w = INF - 1 across a closed one. For heights in [1, INF] -- every
// value of the seeds (1, N + 1 or INF) and of the planes the relaxation
// makes from them -- nbr + INF - 1 >= INF >= x and does not overflow, so a
// closed edge leaves x alone, as the reference's where(cap > 0, nbr + 1,
// INF) does.
//
// Input and output are separate buffers, because neighbouring blocks read
// the input's halo. `changed` is raised once per block, from
// __syncthreads_or over the owned nodes' out != in: relaxation never raises
// a value, so that is the same as "some value moved in some sweep".
//
// With `with_ds` = 0 the same entry point relaxes `dt` alone: that is the
// sink-only global relabel `bfs_heights` of the grid solver.

#include "common.cuh"

namespace {

constexpr int kHalo = 8;   // R_MAX: sweeps one launch may run
constexpr int kVec = 4;    // nodes per thread: one int4 of a window row
constexpr int kMaxThreads = 1024;  // 64 registers a thread at most
constexpr int kMaxSmem = 232448;   // a block's shared-memory limit (sm_90)
constexpr int kClosed = REPRO_INF_H - 1;   // edge weight of a closed edge

__device__ __forceinline__ int4 ld4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}

__device__ __forceinline__ void st4(int* p, const int (&v)[kVec]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// Nodes (i, j .. j + 3) of the plane `p` of one instance, or `fill` outside
// the grid; `n` is the flat index of (i, j), and j a multiple of 4. With
// `vec` (W a multiple of 4, 16-byte aligned planes) the four are all
// inside or all outside the grid and come as one 16-byte load.
template <typename T>
__device__ __forceinline__ void load_row4(T (&out)[kVec],
                                          const T* __restrict__ p,
                                          int64_t n, bool row_in, int j,
                                          int W, bool vec, T fill) {
  static_assert(sizeof(T) == 4, "int32 or float32 planes");
  if (vec) {
    if (row_in && j >= 0 && j < W) {
      const int4 v = *reinterpret_cast<const int4*>(p + n);
      const T* f = reinterpret_cast<const T*>(&v);
      out[0] = f[0]; out[1] = f[1]; out[2] = f[2]; out[3] = f[3];
    } else {
      out[0] = out[1] = out[2] = out[3] = fill;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    out[k] = row_in && j + k >= 0 && j + k < W ? p[n + k] : fill;
  }
}

// One sweep of NP planes (dt, then ds) over this thread's 4 nodes at
// window row r, columns c .. c + 3. `cur[q]` is plane q's window as the
// previous sweep left it; the new values replace `v[q]` and, with `store`,
// are written to `nxt[q]`. `w[j][d]` is the weight of node j's edge in
// direction d. With SEED the node's seed, which `nxt[q]` holds at this
// thread's own nodes until it overwrites them, takes part in the minimum.
template <int NP, bool SEED>
__device__ __forceinline__ void sweep_row(
    int (&v)[NP][kVec], const int (&w)[kVec][4], int* (&cur)[NP],
    int* (&nxt)[NP], bool store, int r, int c, int WH, int WW,
    unsigned wmask, bool first_lane, bool last_lane) {
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    int up[kVec], dn[kVec], seed[kVec];
    const int4 u4 = ld4(cur[q] + max(r - 1, 0) * WW + c);
    const int4 d4 = ld4(cur[q] + min(r + 1, WH - 1) * WW + c);
    up[0] = u4.x; up[1] = u4.y; up[2] = u4.z; up[3] = u4.w;
    dn[0] = d4.x; dn[1] = d4.y; dn[2] = d4.z; dn[3] = d4.w;
    if (SEED) {
      const int4 s4 = ld4(nxt[q] + r * WW + c);
      seed[0] = s4.x; seed[1] = s4.y; seed[2] = s4.z; seed[3] = s4.w;
    }
    int left = __shfl_up_sync(wmask, v[q][kVec - 1], 1);
    int right = __shfl_down_sync(wmask, v[q][0], 1);
    if (first_lane) left = cur[q][r * WW + max(c - 1, 0)];
    if (last_lane) right = cur[q][r * WW + min(c + kVec, WW - 1)];
    int nw[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int l = j > 0 ? v[q][j > 0 ? j - 1 : 0] : left;
      const int rt = j + 1 < kVec ? v[q][j + 1 < kVec ? j + 1 : j] : right;
      int x = __viaddmin_s32(up[j], w[j][REPRO_UP], v[q][j]);
      x = __viaddmin_s32(dn[j], w[j][REPRO_DOWN], x);
      x = __viaddmin_s32(l, w[j][REPRO_LEFT], x);
      x = __viaddmin_s32(rt, w[j][REPRO_RIGHT], x);
      nw[j] = SEED ? min(x, seed[j]) : x;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[q][j] = nw[j];
    if (store) st4(nxt[q] + r * WW + c, nw);
  }
}

// Blocks are (instance, tile) in row-major tile order. Thread t of a block
// of WH * WW / 4 owns window row t / (WW / 4), columns 4 (t % (WW / 4)) ..
// + 3. Shared memory: per plane two WH x WW int32 buffers.
template <bool DS>
__global__ void __launch_bounds__(kMaxThreads) bfs_relabel_sweep_tiles(
    const float* __restrict__ cap, const int* __restrict__ seed_t,
    const int* __restrict__ seed_s, const int* __restrict__ dt_in,
    const int* __restrict__ ds_in, int* __restrict__ dt_out,
    int* __restrict__ ds_out, int* __restrict__ changed, int B, int H,
    int W, int tile_h, int tile_w, int tiles_x, int tiles, int sweeps,
    int vec) {
  constexpr int NP = DS ? 2 : 1;     // planes: dt, then ds
  extern __shared__ int4 smem_raw[];
  int* const smem = reinterpret_cast<int*>(smem_raw);
  const int WH = tile_h + 2 * kHalo;
  const int WW = tile_w + 2 * kHalo;
  const int win = WH * WW;
  int* cur[NP];                      // each plane's buffer 0, then 1
  int* nxt[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    cur[q] = smem + 2 * q * win;
    nxt[q] = smem + (2 * q + 1) * win;
  }
  const int* const in_p[2] = {dt_in, ds_in};
  const int* const seed_p[2] = {seed_t, seed_s};
  int* const out_p[2] = {dt_out, ds_out};

  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int r = threadIdx.x / (WW / kVec);
  const int c = threadIdx.x % (WW / kVec) * kVec;
  const int gi = (tile / tiles_x) * tile_h - kHalo + r;   // in the grid
  const int gj = (tile % tiles_x) * tile_w - kHalo + c;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t P = HW * B;
  const int64_t n = static_cast<int64_t>(b) * HW +
                    static_cast<int64_t>(gi) * W + gj;
  const bool row_in = gi >= 0 && gi < H;
  // Every warp is whole. Its first and last lane read their outer
  // horizontal neighbours from shared memory, the others shuffle.
  const unsigned wmask = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const bool first_lane = lane == 0;
  const bool last_lane = lane == 31;

  // Planes to registers and buffer 0, seeds to buffer 1 (the first sweep
  // reads them there), caps to edge weights. Outside the grid: INF, every
  // edge closed.
  int v[NP][kVec];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    int s[kVec];
    load_row4(v[q], in_p[q], n, row_in, gj, W, vec, REPRO_INF_H);
    load_row4(s, seed_p[q], n, row_in, gj, W, vec, REPRO_INF_H);
    st4(cur[q] + r * WW + c, v[q]);
    st4(nxt[q] + r * WW + c, s);
  }
  int w[kVec][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    float cd[kVec];
    load_row4(cd, cap + d * P, n, row_in, gj, W, vec, 0.f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) w[j][d] = cd[j] > 0.f ? 1 : kClosed;
  }
  __syncthreads();

  // Each sweep reads `cur` and writes `nxt`, then they swap. The last
  // sweep stores nothing: the owned nodes are written from registers.
  sweep_row<NP, true>(v, w, cur, nxt, sweeps > 1, r, c, WH, WW, wmask,
                      first_lane, last_lane);
  for (int s = 1; s < sweeps; ++s) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      int* const t = cur[q];
      cur[q] = nxt[q];
      nxt[q] = t;
    }
    sweep_row<NP, false>(v, w, cur, nxt, s + 1 < sweeps, r, c, WH, WW,
                         wmask, first_lane, last_lane);
  }

  // Write the owned nodes (kHalo deep in the window, inside the grid; a
  // thread's 4 columns are all owned or none) and compare them with the
  // input.
  int moved = 0;
  if (r >= kHalo && r < kHalo + tile_h && c >= kHalo &&
      c < kHalo + tile_w && gi < H && gj < W) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      if (vec) {
        const int4 old = ld4(in_p[q] + n);
        st4(out_p[q] + n, v[q]);
        moved |= (old.x != v[q][0]) | (old.y != v[q][1]) |
                 (old.z != v[q][2]) | (old.w != v[q][3]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (gj + j < W) {
            moved |= in_p[q][n + j] != v[q][j];
            out_p[q][n + j] = v[q][j];
          }
        }
      }
    }
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0) *changed = 1;
}

template <bool DS>
cudaError_t launch(const float* cap, const int* seed_t, const int* seed_s,
                   const int* dt_in, const int* ds_in, int* dt_out,
                   int* ds_out, int* changed, int B, int H, int W,
                   int tile_h, int tile_w, int sweeps, int threads,
                   int smem, int vec, cudaStream_t s) {
  auto kernel = bfs_relabel_sweep_tiles<DS>;
  if (smem > 48 * 1024) {   // the opt-in is per device: set it every time
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const int tiles = ((H + tile_h - 1) / tile_h) * tiles_x;
  kernel<<<static_cast<unsigned>(B) * tiles, threads, smem, s>>>(
      cap, seed_t, seed_s, dt_in, ds_in, dt_out, ds_out, changed, B, H, W,
      tile_h, tile_w, tiles_x, tiles, sweeps, vec);
  return cudaGetLastError();
}

}  // namespace

// Runs `sweeps` (>= 1) sweeps in ceil(sweeps / 8) launches of at most 8
// sweeps each, over tiles of tile_h x tile_w (kernels/bfs_relabel/
// kernel.py's `launch_geometry` picks them). Launch l reads (dt, ds) if
// l == 0, else the buffers launch l - 1 wrote; it writes buffer a if l is
// even, else buffer b; so the result is in a when the launch count is odd,
// in b when even. `changed` (one int32) is zeroed first, then raised by
// any moving value. The caller's geometry (`launch_geometry`) gives the
// block's threads and its shared memory, and every launch uses exactly
// those; this entry only checks them. Returns cudaErrorInvalidValue when
// they are not what the tile needs (one thread per 4 window nodes, a whole
// number of warps, two buffers a plane) or exceed the card's limits, else
// the first launch error.
extern "C" int bfs_relabel_sweeps(const void* cap, const void* seed_t,
                                  const void* seed_s, const void* dt,
                                  const void* ds, void* dt_a, void* ds_a,
                                  void* dt_b, void* ds_b, void* changed,
                                  int B, int H, int W, int sweeps,
                                  int with_ds, int tile_h, int tile_w,
                                  int threads, int smem, void* stream) {
  const int64_t WH = tile_h + 2 * kHalo;
  const int64_t WW = tile_w + 2 * kHalo;
  if (tile_h < 1 || tile_w < 1 || tile_w % kVec ||
      static_cast<int64_t>(threads) * kVec != WH * WW || threads % 32 ||
      threads > kMaxThreads ||
      static_cast<int64_t>(smem) != (with_ds ? 16 : 8) * WH * WW ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<int64_t>(B) * H * W == 0) return 0;
  // 16-byte row loads and stores need W % 4 == 0 and aligned planes
  int vec = W % kVec == 0;
  const void* const planes[] = {cap, seed_t, seed_s, dt, ds, dt_a, ds_a,
                                dt_b, ds_b};
  for (const void* q : planes) vec &= reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const auto* c = static_cast<const float*>(cap);
  const auto* st = static_cast<const int*>(seed_t);
  const auto* ss = static_cast<const int*>(seed_s);
  auto* ch = static_cast<int*>(changed);
  const int* t_in = static_cast<const int*>(dt);
  const int* s_in = static_cast<const int*>(ds);
  for (int done = 0, l = 0; done < sweeps; ++l) {
    const int k = sweeps - done < kHalo ? sweeps - done : kHalo;
    int* t_out = static_cast<int*>(l % 2 == 0 ? dt_a : dt_b);
    int* s_out = static_cast<int*>(l % 2 == 0 ? ds_a : ds_b);
    err = with_ds
        ? launch<true>(c, st, ss, t_in, s_in, t_out, s_out, ch, B, H, W,
                       tile_h, tile_w, k, threads, smem, vec, s)
        : launch<false>(c, st, ss, t_in, s_in, t_out, s_out, ch, B, H, W,
                        tile_h, tile_w, k, threads, smem, vec, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    t_in = t_out;
    s_in = s_out;
    done += k;
  }
  return 0;
}
