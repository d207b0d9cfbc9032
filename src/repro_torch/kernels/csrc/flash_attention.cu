// K6 flash-attention forward for sm_90a on the tensor cores: causal or
// full, GQA, online softmax, out = softmax(scale * q k^T) v per (batch,
// head), float32 or bfloat16 inputs with float32 accumulation.
//
// Replaces the TPU kernel `flash_attention_fwd` of
// src/repro/kernels/flash_attention/kernel.py, which walks a
// (B*H, Sq/256, Sk/512) grid with the key blocks innermost, keeps the
// running max, denominator and accumulator of a 256-row query block in
// VMEM scratch across the key steps, and sends head h to kv head
// h // (H / KV) in its BlockSpec index map. Blocks on Hopper run in no
// order and carry nothing from one to the next, so here one block owns a
// (batch*head, query tile of 64 or 128 rows) and walks the key tiles itself;
// the running statistics live in registers. It reads q (B, Sq, H, dh),
// k (B, Sk, KV, dh) and v (B, Sk, KV, dv) in place (no transposed copy).
//
// Bound: operations. Per (query, key) pair it does 2*dh + 2*dv flops; at
// the serve path's prefill (8 x 1024 tokens, 9 heads over 3 kv heads,
// dh = dv = 64, causal) that is 9.67 GFLOP against 50 MB of q, k, v and o.
// float32 runs each product as three TF32 products (below): 29 TFLOP of
// tensor-core work at 495 TFLOP/s, 0.0586 ms; the FFMA units alone (67
// TFLOP/s) would need 0.1444 ms. bfloat16 runs one bf16 product per
// product at 989 TFLOP/s.
//
// float32 as split TF32: x = hi + lo with hi = tf32_rna(x) and
// lo = tf32_rna(x - hi); a product is lo*hi + hi*lo + hi*hi on the TF32
// tensor cores, summed in float32: max abs error about 4e-6 at the serve
// shape on the card, against about 1e-3 for one TF32 product and a 3e-5
// tolerance.
//
// Two kernels, chosen by shape (`launch_geometry` in
// kernels/flash_attention/kernel.py, the one owner of the launch geometry;
// the C entry launches with it and only checks that it fits, `fits`):
// - flash_fwd_wgmma: float32 with dh, dv <= 64, the serve path's class.
//   `wgmma.m64n64k8.tf32`, two warpgroups of 64 query rows a block. Per
//   key tile the block splits k, and v transposed, once into hi and lo
//   planes in shared memory (the operand `wgmma` reads from there must be
//   K-major: v's keys contiguous); q's and p's split fragments stay in
//   registers. Measured on an H100 (tests/torch_smoke_k6_ablation.py),
//   the work around the products (loads, the split pass, the softmax)
//   takes about as long as the products: they do not overlap.
//   q's split fragments are loaded once and read by every key tile's
//   q k^T as wgmma A operands. ptxas of CUDA 12.9 (V12.9.86) does not
//   always keep them: for a variant whose PV product is hi*hi alone
//   (variant `pv_hi` of the ablation script) its SASS hands 12 of their
//   registers to the softmax inside the key loop, though the PTX keeps
//   them live across it, so every key tile after the first gets wrong
//   scores. The fences and waits here are not the cause: the variant
//   stays wrong with a wait after every wgmma. This file's build loses
//   none (the script counts them per variant); a change to this kernel
//   is to be checked for it, and by the multi-tile shapes of the tests.
// - flash_fwd_mma: every other shape (bf16, dh or dv above 64), FA2-style
//   `mma.sync` (m16n8k8 TF32, m16n8k16 bf16), 4 warps of 16 query rows.
//   Each warp splits the k and v fragments it reads in registers; q is
//   split once per block into registers (dh, dv <= 64) or per use from
//   shared memory (the key tile halves to 32 there).
// In both, S = q k^T stays in registers as accumulator fragments and P
// never leaves registers: the contraction over keys is order-free, so the
// PV product's k index is permuted to what each thread's S fragment holds.
// In TF32, logical k = t and t + 4 of a k8 step are keys 2t and 2t + 1 of
// the S fragment's n8 tile (a0..a3 = c0, c2, c1, c3), and v's keys are
// read (mma.sync) or stored (wgmma) in that order; in bf16 the S fragments
// of two n8 tiles are the A fragment of a k16 step as they are. mma.sync
// also permutes dh inside 16 (float32) or 32 (bf16) columns and v's
// columns inside 32, so a thread reads q, k and v rows as vectors.
// K and v tiles come through a two-stage ring in shared memory, loaded by
// `cp.async` (16 bytes a thread where rows and pointers allow, else 4;
// bf16 with odd dh copies synchronously), so the next tile's load is in
// flight while this one computes. Rows past Sk are zero-filled by the
// copy; dh and dv are zero-padded once per block. Row strides keep the
// fragment reads free of bank conflicts. Key tiles wholly above the
// diagonal are skipped (per block, and a warp or warpgroup skips a tile
// above all of its rows), only diagonal and tail tiles are masked, and
// the heaviest query tiles are scheduled first (the query tile is the
// slow grid axis, counted down).
//
// Semantics kept from the Pallas kernel: NEG_INF = -1e30 for a causally
// masked score (top-left aligned: pos_q >= pos_k, both from 0), l clamped
// at 1e-30 before the division, and for bfloat16 the probabilities are
// rounded to bfloat16 before the PV product while l sums them unrounded.
// Tails of Sq and Sk are masked, so any length works; key columns past Sk
// get no weight at all. The softmax runs in base 2 on scores scaled by
// scale * log2(e). Given a non-null `lse`, both kernels also write each
// row's natural log-sum-exp, m ln 2 + ln l, in float32: the residual from
// which the training backward (plain PyTorch, `_FlashCore` in
// models/attention.py, after the JAX package's `_flash_core_bwd`)
// recomputes the probabilities.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 128;  // 4 warps of 16 query rows
constexpr int kStages = 2;     // K/V ring depth
constexpr int kQRegMax = 64;   // dh, dv up to this: q fragments in registers
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// How one call is launched, as `launch_geometry` in kernel.py chooses it
// and passes it; the C entry launches with it after `fits` checks it.
struct Geometry {
  int wgmma;      // 1: float32 with dh, dv <= 64 on flash_fwd_wgmma
  int q_reg;      // 1: q fragments in registers, key tile 64; 0: q in smem, 32
  int block_k;    // keys per tile
  int dh_pad;     // dh padded to a whole chunk of two k steps
  int dv_pad;     // dv padded to whole 32-column groups
  int dv_class;   // template width of the output accumulator: 64, 128, 256
  int k_stride;   // elements per row of a k (and q) tile in shared memory
  int v_stride;   // elements per row of a v tile
  int smem;       // dynamic shared memory bytes
  int grid_x;     // B * H
  int grid_y;     // query tiles
};

// tf32_rna(x) as cvt.rna.tf32.f32 rounds it (nearest, ties away from zero;
// infinities stay), in two integer ops: cvt runs at the conversion rate,
// and the kernel is slower with it on an H100 (variant `cvt` of
// tests/torch_smoke_k6_ablation.py). The 13 low bits are cleared, so
// x - tf32(x) is exact.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp; results under 2^-126 flush
// to 0, which no tolerance here can see).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo to 22 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b as three TF32 products, small terms first.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ahi,
                                           const uint32_t* alo, uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(c, alo, bh0, bh1);
  mma_tf32(c, ahi, bl0, bl1);
  mma_tf32(c, ahi, bh0, bh1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ __forceinline__ uint4 lds128(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ uint2 lds64(const T* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) of a (n_valid, width) matrix with `stride`
// elements between rows into dst (`dst_stride` apart); rows at or past
// n_valid become zeros. `ch` bytes a copy: 16 or 4 through cp.async, 2
// (bf16 with odd width) synchronously. width * sizeof(T) % ch == 0.
template <int NT = kThreads, typename T>
__device__ __forceinline__ void load_rows(T* dst, int dst_stride,
                                          const T* src, int64_t stride,
                                          int row0, int rows, int n_valid,
                                          int width, int ch) {
  const int per = ch / static_cast<int>(sizeof(T));
  const int cpr = width / per;
  const int total = rows * cpr;
  int r = threadIdx.x / cpr;
  int c = threadIdx.x - r * cpr;
  const int dr = NT / cpr;
  const int dc = NT - dr * cpr;
  for (int i = threadIdx.x; i < total; i += NT) {
    const bool ok = row0 + r < n_valid;
    const T* s = ok ? src + (row0 + r) * stride + c * per : src;
    T* d = dst + r * dst_stride + c * per;
    if (ch == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(d)),
                   "l"(s), "r"(ok ? 16 : 0)
                   : "memory");
    } else if (ch == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(d)),
                   "l"(s), "r"(ok ? 4 : 0)
                   : "memory");
    } else {
      *reinterpret_cast<unsigned short*>(d) =
          ok ? *reinterpret_cast<const unsigned short*>(s) : 0;
    }
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// A fragments of one dh chunk (two k steps) of a warp's 16 q rows: from
// the 16-byte vectors of rows g and g + 8 at the chunk's columns
// 4 tig.. (float32) or 8 tig.. (bf16). In float32 each k8 step takes
// columns (4 tig, 4 tig + 1), then (4 tig + 2, 4 tig + 3), as logical
// k = (tig, tig + 4); in bf16 each k16 step takes words (0, 1), then
// (2, 3). k fragments are read with the same permutation.
template <typename T>
struct QFrag;

template <>
struct QFrag<float> {
  uint32_t hi[2][4], lo[2][4];
  __device__ __forceinline__ void set(uint4 r0, uint4 r8) {
    const uint32_t w[2][4] = {{r0.x, r8.x, r0.y, r8.y},
                              {r0.z, r8.z, r0.w, r8.w}};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(w[s][i]), hi[s][i], lo[s][i]);
    }
  }
  // s += q k^T over the chunk for one n8 tile of keys; kv is the key
  // row's 16-byte vector at the chunk's columns 4 tig..
  __device__ __forceinline__ void mma(float* s, uint4 kv) const {
    uint32_t h0, l0, h1, l1, h2, l2, h3, l3;
    split(__uint_as_float(kv.x), h0, l0);
    split(__uint_as_float(kv.y), h1, l1);
    split(__uint_as_float(kv.z), h2, l2);
    split(__uint_as_float(kv.w), h3, l3);
    mma_3xtf32(s, hi[0], lo[0], h0, h1, l0, l1);
    mma_3xtf32(s, hi[1], lo[1], h2, h3, l2, l3);
  }
};

template <>
struct QFrag<__nv_bfloat16> {
  uint32_t a[2][4];
  __device__ __forceinline__ void set(uint4 r0, uint4 r8) {
    a[0][0] = r0.x; a[0][1] = r8.x; a[0][2] = r0.y; a[0][3] = r8.y;
    a[1][0] = r0.z; a[1][1] = r8.z; a[1][2] = r0.w; a[1][3] = r8.w;
  }
  __device__ __forceinline__ void mma(float* s, uint4 kv) const {
    mma_bf16(s, a[0], kv.x, kv.y);
    mma_bf16(s, a[1], kv.z, kv.w);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One (batch*head, 64-row query tile) per block: blockIdx.x = b * H + h,
// blockIdx.y counts the query tiles down (heaviest first under causal).
// kQReg (bf16 with dh, dv <= 64; float32 there runs flash_fwd_wgmma): q
// fragments in registers, key tile 64, q staged in ring stage 1 before the
// loop; else q stays in shared memory, key tile 32.
// kDV bounds dv_pad (32-column groups past dv_pad are skipped).
template <typename T, bool kQReg, int kDV>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int H, int KV, int dh, int dv, Geometry geo, int ch_q,
    int ch_k, int ch_v, int vec_o, float sl2, int causal) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int BK = kQReg ? 64 : 32;
  constexpr int NT = BK / 8;                 // n8 tiles of S per warp
  constexpr int NG = kDV / 32;               // 32-column groups of o
  constexpr int KC = kF32 ? 16 : 32;         // dh per chunk (two k steps)
  constexpr int VE = 16 / sizeof(T);         // elements per 16 bytes
  constexpr int NQ = kQReg ? kQRegMax / KC : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int sk = geo.k_stride, sv = geo.v_stride;
  const int stage = BK * (sk + sv);
  T* Qs = kQReg ? ring + stage : ring + kStages * stage;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int qw = q0 + 16 * warp;             // the warp's first row
  const int qw_last = min(qw + 15, Sq - 1);

  const int64_t q_row = static_cast<int64_t>(H) * dh;
  const int64_t k_row = static_cast<int64_t>(KV) * dh;
  const int64_t v_row = static_cast<int64_t>(KV) * dv;
  const T* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * dh;
  const T* kb = k + (static_cast<int64_t>(b) * Sk * KV + kvh) * dh;
  const T* vb = v + (static_cast<int64_t>(b) * Sk * KV + kvh) * dv;

  {  // zero the pads once: the copies below write only real columns
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int i = tid; i < geo.smem / 16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {  // tiles whose first key lies past the block's last row
    n_tiles = min(n_tiles, (min(q0 + kBQ, Sq) - 1) / BK + 1);
  }
  load_rows(Qs, sk, qb, q_row, q0, kBQ, Sq, dh, ch_q);
  load_rows(ring, sk, kb, k_row, 0, BK, Sk, dh, ch_k);
  load_rows(ring + BK * sk, sv, vb, v_row, 0, BK, Sk, dv, ch_v);
  cp_async_commit();

  const T* q_g = Qs + (16 * warp + g) * sk + tig * VE;  // row g, chunk 0
  QFrag<T> qf[NQ];
  if constexpr (kQReg) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      if (c * KC < geo.dh_pad) qf[c].set(lds128(q_g + c * KC), lds128(q_g + 8 * sk + c * KC));
    }
  }  // the loop's first barrier frees ring stage 1 for tile 1

  float acc[NG][4][4];
#pragma unroll
  for (int G = 0; G < NG; ++G) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[G][t][e] = 0.f;
    }
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's columns; summed over the quad at the end
  const bool warp_live = qw < Sq;

  for (int kt = 0; kt < n_tiles; ++kt) {
    // One barrier a tile: after it tile kt is in for every thread, and
    // every warp is done with tile kt - 1, whose stage takes tile kt + 1.
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < n_tiles) {
      T* Kd = ring + ((kt + 1) % kStages) * stage;
      load_rows(Kd, sk, kb, k_row, (kt + 1) * BK, BK, Sk, dh, ch_k);
      load_rows(Kd + BK * sk, sv, vb, v_row, (kt + 1) * BK, BK, Sk, dv, ch_v);
    }
    cp_async_commit();
    const int k0 = kt * BK;
    if (warp_live && !(causal && k0 > qw_last)) {
      const T* Ks = ring + (kt % kStages) * stage;
      const T* Vs = Ks + BK * sk;
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
      const T* k_g = Ks + g * sk + tig * VE;
      if constexpr (kQReg) {
#pragma unroll
        for (int c = 0; c < NQ; ++c) {
          if (c * KC < geo.dh_pad) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) qf[c].mma(s[nt], lds128(k_g + 8 * nt * sk + c * KC));
          }
        }
      } else {
        for (int c = 0; c < geo.dh_pad; c += KC) {
          qf[0].set(lds128(q_g + c), lds128(q_g + 8 * sk + c));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) qf[0].mma(s[nt], lds128(k_g + 8 * nt * sk + c));
        }
      }

      // online softmax over this tile (rows g and g + 8 of the warp)
      const bool masked = (causal && k0 + BK - 1 > qw) || k0 + BK > Sk;
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * sl2;
          if (masked) {
            const int c = k0 + 8 * nt + 2 * tig + (e & 1);
            const int r = qw + g + 8 * (e >> 1);
            if (c >= Sk) {
              x = -CUDART_INF_F;  // no such key
            } else if (causal && r < c) {
              x = kNegInf;
            }
          }
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        corr[i] = exp2_approx(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(s[nt][e] - m[e >> 1]);
          sum[e >> 1] += p;
          s[nt][e] = p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
      for (int G = 0; G < NG; ++G) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[G][t][0] *= corr[0];
          acc[G][t][1] *= corr[0];
          acc[G][t][2] *= corr[1];
          acc[G][t][3] *= corr[1];
        }
      }

      // o += p v. Output column of logical (group G, n8 tile t, column n)
      // is 32 G + 4 n + t, so a thread reads v rows as vectors at 4 g.
      if constexpr (kF32) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {  // k8 step j = S's n8 tile j
          uint32_t ahi[4], alo[4];
          split(s[j][0], ahi[0], alo[0]);
          split(s[j][2], ahi[1], alo[1]);
          split(s[j][1], ahi[2], alo[2]);
          split(s[j][3], ahi[3], alo[3]);
          const T* v0 = Vs + (8 * j + 2 * tig) * sv + 4 * g;
#pragma unroll
          for (int G = 0; G < NG; ++G) {
            if (32 * G < geo.dv_pad) {
              const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * G);
              const float4 x1 = *reinterpret_cast<const float4*>(v0 + sv + 32 * G);
              const float r0[4] = {x0.x, x0.y, x0.z, x0.w};
              const float r1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                uint32_t h0, l0, h1, l1;
                split(r0[t], h0, l0);
                split(r1[t], h1, l1);
                mma_3xtf32(acc[G][t], ahi, alo, h0, h1, l0, l1);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {  // k16 step j = n8 tiles 2j, 2j+1
          const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                 pack_bf16(s[2 * j][2], s[2 * j][3]),
                                 pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                 pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
          const T* v0 = Vs + (16 * j + 2 * tig) * sv + 4 * g;
#pragma unroll
          for (int G = 0; G < NG; ++G) {
            if (32 * G < geo.dv_pad) {
              const uint2 r0 = lds64(v0 + 32 * G);
              const uint2 r1 = lds64(v0 + sv + 32 * G);
              const uint2 r8 = lds64(v0 + 8 * sv + 32 * G);
              const uint2 r9 = lds64(v0 + 9 * sv + 32 * G);
              const uint32_t w0[2] = {r0.x, r0.y}, w1[2] = {r1.x, r1.y};
              const uint32_t w8[2] = {r8.x, r8.y}, w9[2] = {r9.x, r9.y};
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
                mma_bf16(acc[G][t], a, __byte_perm(w0[t >> 1], w1[t >> 1], sel),
                         __byte_perm(w8[t >> 1], w9[t >> 1], sel));
              }
            }
          }
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + g + 8 * i;
    const float li = fmaxf(quad_sum(l[i]), 1e-30f);
    const float inv = 1.f / li;
    if (r >= Sq) continue;
    // m is in base 2 (scores scaled by scale * log2 e): lse = m ln 2 + ln l
    if (lse != nullptr && tig == 0) {
      lse[static_cast<int64_t>(blockIdx.x) * Sq + r] =
          m[i] * kLn2 + logf(li);
    }
    T* orow = o + ((static_cast<int64_t>(b) * Sq + r) * H + h) * dv;
#pragma unroll
    for (int G = 0; G < NG; ++G) {
      const int c0 = 32 * G + 8 * tig;  // this thread's 8 columns
      if (32 * G >= geo.dv_pad || c0 >= dv) continue;
      float x[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        x[t] = acc[G][t][2 * i] * inv;
        x[4 + t] = acc[G][t][2 * i + 1] * inv;
      }
      if (vec_o && c0 + 8 <= dv) {
        if constexpr (kF32) {
          reinterpret_cast<float4*>(orow + c0)[0] = make_float4(x[0], x[1], x[2], x[3]);
          reinterpret_cast<float4*>(orow + c0)[1] = make_float4(x[4], x[5], x[6], x[7]);
        } else {
          *reinterpret_cast<uint4*>(orow + c0) =
              make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                         pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
        }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (c0 + n < dv) {
            if constexpr (kF32) {
              orow[c0 + n] = x[n];
            } else {
              orow[c0 + n] = __float2bfloat16(x[n]);
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// flash_fwd_wgmma. Per 64-key tile: the raw k and v tiles (cp.async ring)
// are split by all 256 threads into hi and lo planes, k as [key][dh] and v
// transposed as [dv][key], both in the no-swizzle K-major core-matrix
// layout (8 rows x 16 bytes per core matrix, LBO 128 bytes along K, SBO
// 2048 bytes between 8-row groups); v's keys within each k8 step in p's
// fragment order. Then each warpgroup runs S = q k^T and o += p v as 8 k8
// steps of three m64n64k8 products each, waiting on each before the
// softmax needs its result.

constexpr int kWgBQ = 128;       // query rows per block: 2 warpgroups
constexpr int kWgThreads = 256;
constexpr int kWgBK = 64;        // keys per tile
constexpr int kWgD = 64;         // dh and dv padded to this
constexpr int kWgStride = kWgD + 4;  // raw q, k, v rows in shared memory

__device__ __forceinline__ uint64_t gmma_desc(const float* p, int lbo_bytes,
                                              int sbo_bytes) {
  // no swizzle (layout type 0), base offset 0
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32);
}

// Pin register operands of wgmma at this point of the program: computed
// before it, and read after it. wgmma reads its A fragments and
// accumulators asynchronously, between `wgmma.fence` and the wait, where
// the compiler must neither write them nor read the results early.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_frag(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
  }
}

// d (+)= a b for one m64n64k8 TF32 step: a from registers, b from smem.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t* a,
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// d = or += a b over K = 64 as 8 k8 steps of three TF32 products; the
// b planes advance 256 bytes (two core matrices) a step.
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[32],
                                             uint32_t (&ahi)[8][4],
                                             uint32_t (&alo)[8][4],
                                             const float* bhi,
                                             const float* blo,
                                             bool accumulate) {
  fence_acc(d);
  fence_frag(ahi);
  fence_frag(alo);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint64_t dh = gmma_desc(bhi + 64 * s, 128, 2048);
    const uint64_t dl = gmma_desc(blo + 64 * s, 128, 2048);
    wgmma_tf32(d, alo[s], dh, accumulate || s > 0);
    wgmma_tf32(d, ahi[s], dl, 1);
    wgmma_tf32(d, ahi[s], dh, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
  fence_frag(ahi);
  fence_frag(alo);
}

__global__ void __launch_bounds__(kWgThreads) flash_fwd_wgmma(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int KV, int dh, int dv,
    Geometry geo, int ch_q, int ch_k, int ch_v, float sl2, int causal) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  float* ring = reinterpret_cast<float*>(smem_wg);
  constexpr int stage = kWgBK * 2 * kWgStride;  // raw k then raw v
  float* khi = ring + kStages * stage;  // [8 key groups][16 dh chunks][8][4]
  float* klo = khi + kWgBK * kWgD;
  float* vhi = klo + kWgBK * kWgD;      // [8 dv groups][16 key chunks][8][4]
  float* vlo = vhi + kWgBK * kWgD;
  float* Qs = khi;                      // q staged before the loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;
  const int qg = q0 + 64 * (warp >> 2);        // the warpgroup's first row
  const int qw = qg + 16 * (warp & 3);         // the warp's first row
  const int qg_last = min(qg + 63, Sq - 1);

  const float* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * dh;
  const float* kb = k + (static_cast<int64_t>(b) * Sk * KV + kvh) * dh;
  const float* vb = v + (static_cast<int64_t>(b) * Sk * KV + kvh) * dv;
  const int64_t q_row = static_cast<int64_t>(H) * dh;
  const int64_t k_row = static_cast<int64_t>(KV) * dh;
  const int64_t v_row = static_cast<int64_t>(KV) * dv;

  {
    uint4* z = reinterpret_cast<uint4*>(smem_wg);
    for (int i = tid; i < geo.smem / 16; i += kWgThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  int n_tiles = (Sk + kWgBK - 1) / kWgBK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kWgBQ, Sq) - 1) / kWgBK + 1);
  load_rows<kWgThreads>(Qs, kWgStride, qb, q_row, q0, kWgBQ, Sq, dh, ch_q);
  load_rows<kWgThreads>(ring, kWgStride, kb, k_row, 0, kWgBK, Sk, dh, ch_k);
  load_rows<kWgThreads>(ring + kWgBK * kWgStride, kWgStride, vb, v_row, 0,
                        kWgBK, Sk, dv, ch_v);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qhi[8][4], qlo[8][4];  // natural k order: (t, t + 4) of each k8
  {
    const float* r0 = Qs + (qw - q0 + g) * kWgStride + t;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      split(r0[8 * s], qhi[s][0], qlo[s][0]);
      split(r0[8 * kWgStride + 8 * s], qhi[s][1], qlo[s][1]);
      split(r0[8 * s + 4], qhi[s][2], qlo[s][2]);
      split(r0[8 * kWgStride + 8 * s + 4], qhi[s][3], qlo[s][3]);
    }
  }

  float acc[32], S[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt in; the planes of tile kt - 1 are read
    if (kt + 1 < n_tiles) {
      float* Kd = ring + ((kt + 1) % kStages) * stage;
      load_rows<kWgThreads>(Kd, kWgStride, kb, k_row, (kt + 1) * kWgBK,
                            kWgBK, Sk, dh, ch_k);
      load_rows<kWgThreads>(Kd + kWgBK * kWgStride, kWgStride, vb, v_row,
                            (kt + 1) * kWgBK, kWgBK, Sk, dv, ch_v);
    }
    cp_async_commit();
    {  // split tile kt into the planes; n (key or dv column) fastest
      const float* Kr = ring + (kt % kStages) * stage;
      const float* Vr = Kr + kWgBK * kWgStride;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int idx = tid + kWgThreads * it;
        const int n = idx & 63, c = idx >> 6;   // c: 16 chunks of 4
        const int off = (n >> 3) * 512 + c * 32 + (n & 7) * 4;
        const float4 x = *reinterpret_cast<const float4*>(Kr + n * kWgStride + 4 * c);
        uint4 hi, lo;
        split(x.x, hi.x, lo.x);
        split(x.y, hi.y, lo.y);
        split(x.z, hi.z, lo.z);
        split(x.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(khi + off) = hi;
        *reinterpret_cast<uint4*>(klo + off) = lo;
        // v: chunk c holds keys 8 (c / 2) + 2 u + c % 2, u = 0..3
        const float* vc = Vr + (8 * (c >> 1) + (c & 1)) * kWgStride + n;
        split(vc[0], hi.x, lo.x);
        split(vc[2 * kWgStride], hi.y, lo.y);
        split(vc[4 * kWgStride], hi.z, lo.z);
        split(vc[6 * kWgStride], hi.w, lo.w);
        *reinterpret_cast<uint4*>(vhi + off) = hi;
        *reinterpret_cast<uint4*>(vlo + off) = lo;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the planes are in, for the async proxy too
    const int k0 = kt * kWgBK;
    if (qg < Sq && !(causal && k0 > qg_last)) {
      wgmma_3xtf32(S, qhi, qlo, khi, klo, false);
      const bool masked = (causal && k0 + kWgBK - 1 > qw) || k0 + kWgBK > Sk;
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = S[i] * sl2;
        if (masked) {
          const int c = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const int r = qw + g + 8 * ((i >> 1) & 1);
          if (c >= Sk) {
            x = -CUDART_INF_F;
          } else if (causal && r < c) {
            x = kNegInf;
          }
        }
        S[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = exp2_approx(m[r] - m_new);
        m[r] = m_new;
      }
      uint32_t phi[8][4], plo[8][4];  // k8 step j: keys (2t, 2t + 1) of n8 tile j
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2_approx(S[4 * j + e] - m[e >> 1]);
          sum[e >> 1] += p[e];
        }
        split(p[0], phi[j][0], plo[j][0]);
        split(p[2], phi[j][1], plo[j][1]);
        split(p[1], phi[j][2], plo[j][2]);
        split(p[3], phi[j][3], plo[j][3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= corr[(i >> 1) & 1];
      wgmma_3xtf32(acc, phi, plo, vhi, vlo, true);
    }
  }

  if (qw >= Sq) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
    const float inv = 1.f / lr;
    if (row >= Sq) continue;
    if (lse != nullptr && t == 0) {  // base-2 m, as in flash_fwd_mma
      lse[static_cast<int64_t>(blockIdx.x) * Sq + row] =
          m[r] * kLn2 + logf(lr);
    }
    float* orow = o + ((static_cast<int64_t>(b) * Sq + row) * H + h) * dv;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < dv) orow[c] = acc[4 * j + 2 * r] * inv;
      if (c + 1 < dv) orow[c + 1] = acc[4 * j + 2 * r + 1] * inv;
    }
  }
}

// Whether `g` fits the kernel it picks, the shapes and the card: the
// kernels index shared memory and pick their template by these values.
bool fits(const Geometry& g, int B, int Sq, int H, int dh, int dv, int es) {
  const int bq = g.wgmma ? kWgBQ : kBQ;
  if (g.grid_x != B * H || g.grid_y != (Sq + bq - 1) / bq ||
      g.grid_y > 65535 || g.smem > 227 * 1024 || g.smem % 16 != 0) {
    return false;
  }
  if (g.wgmma) {  // flash_fwd_wgmma's fixed layout
    return es == 4 && g.q_reg == 1 && dh <= kWgD && dv <= kWgD &&
           g.block_k == kWgBK && g.dh_pad == kWgD && g.dv_pad == kWgD &&
           g.dv_class == kWgD && g.k_stride == kWgStride &&
           g.v_stride == kWgStride &&
           g.smem == (kStages * kWgBK * 2 * kWgStride + 4 * kWgBK * kWgD) * es;
  }
  const int kc = es == 4 ? 16 : 32;  // dh of two k steps
  const int cap = g.q_reg ? kQRegMax : 256;
  return g.wgmma == 0 && !(es == 4 && g.q_reg) &&
         g.block_k == (g.q_reg ? 64 : 32) && g.dh_pad >= dh &&
         g.dh_pad % kc == 0 && g.dh_pad <= cap && g.dv_pad >= dv &&
         g.dv_pad % 32 == 0 && g.dv_pad <= g.dv_class &&
         (!g.q_reg || g.dv_class == 64) &&
         (g.dv_class == 64 || g.dv_class == 128 || g.dv_class == 256) &&
         g.k_stride >= g.dh_pad && g.k_stride * es % 16 == 0 &&
         g.v_stride >= g.dv_pad && g.v_stride * es % 16 == 0 &&
         g.smem == (kStages * g.block_k * (g.k_stride + g.v_stride) +
                    (g.q_reg ? 0 : kBQ * g.k_stride)) * es;
}

// Largest copy (16, 4 or 2 bytes) that every row of `width` elements at p
// allows.
int chunk_bytes(const void* p, int width, int esize) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int row = width * esize;
  if (row % 16 == 0 && a % 16 == 0) return 16;
  if (row % 4 == 0 && a % 4 == 0) return 4;
  return 2;
}

template <typename T, bool kQReg, int kDV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int KV, int dh,
                   int dv, const Geometry& geo, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_mma<T, kQReg, kDV>;
  if (geo.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    if (err != cudaSuccess) return err;
  }
  const int es = static_cast<int>(sizeof(T));
  const int vec_o = (dv * es) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(o) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(geo.grid_x),
                  static_cast<unsigned>(geo.grid_y));
  kernel<<<grid, kThreads, geo.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KV, dh,
      dv, geo, chunk_bytes(q, dh, es), chunk_bytes(k, dh, es),
      chunk_bytes(v, dv, es), vec_o, scale * kLog2e, causal);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int Sq, int Sk, int H,
                         int KV, int dh, int dv, const Geometry& geo,
                         float scale, int causal, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      geo.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(geo.grid_x),
                  static_cast<unsigned>(geo.grid_y));
  flash_fwd_wgmma<<<grid, kWgThreads, geo.smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H,
      KV, dh, dv, geo, chunk_bytes(q, dh, 4), chunk_bytes(k, dh, 4),
      chunk_bytes(v, dv, 4), scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Sq, int Sk, int H, int KV, int dh,
                     int dv, const Geometry& geo, float scale, int causal,
                     cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (geo.wgmma) {  // every float32 call with q in registers
      return launch_wgmma(q, k, v, o, lse, B, Sq, Sk, H, KV, dh, dv, geo,
                          scale, causal, stream);
    }
  } else if (geo.q_reg) {
    return launch<T, true, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, dh, dv,
                               geo, scale, causal, stream);
  }
  if (geo.dv_class == 64) {
    return launch<T, false, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, dh, dv,
                                geo, scale, causal, stream);
  }
  if (geo.dv_class == 128) {
    return launch<T, false, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, dh, dv,
                                 geo, scale, causal, stream);
  }
  return launch<T, false, 256>(q, k, v, o, lse, B, Sq, Sk, H, KV, dh, dv,
                               geo, scale, causal, stream);
}

}  // namespace

// q (B, Sq, H, dh), k (B, Sk, KV, dh), v (B, Sk, KV, dv), all contiguous
// and of one type (bf16 = 0: float32, 1: bfloat16); writes o (B, Sq, H, dv)
// of that type and, where `lse` is not null, each row's float32
// log-sum-exp of its scaled scores into lse (B, H, Sq) (the residual of
// the backward pass). H % KV == 0, 1 <= dh, dv <= 256, Sk >= 1. `geo`
// holds the caller's launch geometry: wgmma, q_reg, block_k, dh_pad,
// dv_pad, dv_class, k_stride, v_stride, smem bytes, grid x, grid y
// (launch_geometry in kernel.py); a call whose geometry does not fit
// (`fits`) is refused.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse_out,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int dh, int dv, int bf16, float scale,
                                   int causal,
                                   const int* geo_in, void* stream) {
  if (B > 0 && Sq > 0 && H > 0) {
    const Geometry geo = {geo_in[0], geo_in[1], geo_in[2], geo_in[3],
                          geo_in[4], geo_in[5], geo_in[6], geo_in[7],
                          geo_in[8], geo_in[9], geo_in[10]};
    if (Sk < 1 || KV < 1 || H % KV != 0 || dh < 1 || dh > 256 || dv < 1 ||
        dv > 256 || !fits(geo, B, Sq, H, dh, dv, bf16 ? 2 : 4)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* lse = static_cast<float*>(lse_out);
    const cudaError_t err =
        bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                       dh, dv, geo, scale, causal, s)
             : dispatch<float>(q, k, v, o, lse, B, Sq, Sk, H, KV, dh, dv,
                               geo, scale, causal, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
