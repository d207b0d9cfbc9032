// K6 flash-attention forward for sm_90a: causal or full, GQA, online
// softmax, out = softmax(scale * q k^T) v per (batch, head), float32 or
// bfloat16 inputs with float32 accumulation.
//
// Replaces the TPU kernel `flash_attention_fwd` of
// src/repro/kernels/flash_attention/kernel.py, which walks a
// (B*H, Sq/256, Sk/512) grid with the key blocks innermost, keeps the
// running max, denominator and accumulator of a 256-row query block in
// VMEM scratch across the key steps, and sends head h to kv head
// h // (H / KV) in its BlockSpec index map. Blocks on Hopper run in no
// order and carry nothing from one to the next, so here one block owns a
// (batch*head, 64-row query tile) and walks the key tiles itself in a loop;
// the running statistics live in registers. It reads q (B, Sq, H, dh),
// k (B, Sk, KV, dh) and v (B, Sk, KV, dv) in place (no transposed copy).
//
// Bound: operations. Per (query, key) pair it does 2*dh + 2*dv flops;
// at the serve path's prefill (8 x 1024 tokens, 9 heads over 3 kv heads,
// dh = dv = 64, causal) that is about 9.7 GFLOP against some 50 MB of
// q, k, v and o. This first kernel keeps float32 off the tensor cores
// (TF32's 10-bit mantissa would break the 3e-5 tolerance against the
// plain version), so its ceiling is the 67 TFLOP/s of the FFMA units:
// about 0.14 ms. Each thread owns a 4 x 4 block of the score tile (rows
// ty + 16 i, keys tx + 16 j) and reads q and k from shared memory as
// 16-byte vectors (row stride dh + 4 floats, so a quarter warp's k reads
// hit distinct banks), then 4 rows x up to 16 output columns of the PV
// product. Key tiles wholly above the diagonal are skipped, and the query
// tiles are scheduled heaviest first. wgmma, TMA and warp specialisation are
// later work.
//
// Semantics kept from the Pallas kernel: NEG_INF = -1e30 for a causally
// masked score (top-left aligned: pos_q >= pos_k, both from 0), l clamped
// at 1e-30 before the division, and for bfloat16 the probabilities are
// rounded to bfloat16 before the PV product while l sums them unrounded.
// Tails of Sq and Sk are masked, so any length works; key columns past Sk
// get no weight at all.

#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, each 4 rows x 4 keys
constexpr int kPS = kBK + 4;   // row stride of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A probability as the PV product's operand: p.astype(v.dtype).
template <typename T>
__device__ __forceinline__ float operand(float p) {
  return to_f32(from_f32<T>(p));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

// One (batch*head, query tile) per block. Each thread's output columns are
// tx + 16 j for j < NV (dv <= 16 NV); dhp = dh rounded up to 4, the pad
// zero-filled in shared memory.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
    int KV, int dh, int dv, int dhp, float scale, int causal) {
  constexpr int VS = NV * 16;   // row stride of the v tile
  extern __shared__ __align__(16) float smem[];
  const int qs = dhp + 4;       // row stride of the q and k tiles
  float* Qs = smem;             // kBQ x qs
  float* Ks = Qs + kBQ * qs;    // kBK x qs
  float* Vs = Ks + kBK * qs;    // kBK x VS
  float* Ps = Vs + kBK * VS;    // kBQ x kPS

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first

  const int64_t q_row = static_cast<int64_t>(H) * dh;
  const int64_t k_row = static_cast<int64_t>(KV) * dh;
  const int64_t v_row = static_cast<int64_t>(KV) * dv;
  const T* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * dh;
  const T* kb = k + (static_cast<int64_t>(b) * Sk * KV + kvh) * dh;
  const T* vb = v + (static_cast<int64_t>(b) * Sk * KV + kvh) * dv;

  for (int i = tid; i < kBQ * dhp; i += kThreads) {
    const int r = i / dhp;
    const int d = i - r * dhp;
    Qs[r * qs + d] =
        (q0 + r < Sq && d < dh) ? to_f32(qb[(q0 + r) * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {  // tiles whose first key lies past the tile's last query
    n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's Ks, Vs and Ps are read
    for (int i = tid; i < kBK * dhp; i += kThreads) {
      const int r = i / dhp;
      const int d = i - r * dhp;
      Ks[r * qs + d] =
          (k0 + r < Sk && d < dh) ? to_f32(kb[(k0 + r) * k_row + d]) : 0.f;
    }
    for (int i = tid; i < kBK * VS; i += kThreads) {
      const int r = i / VS;
      const int n = i - r * VS;
      Vs[i] = (k0 + r < Sk && n < dv) ? to_f32(vb[(k0 + r) * v_row + n])
                                      : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < dhp; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * qs + d]);
        kv[i] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * i) * qs + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (c >= Sk) {
          x = -CUDART_INF_F;      // no such key
        } else if (causal && r < c) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = operand<T>(p);
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kPS + c]);
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float* vc = &Vs[c * VS + tx + 16 * j];
        const float v0 = vc[0], v1 = vc[VS], v2 = vc[2 * VS], v3 = vc[3 * VS];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = acc[i][j];
          t = fmaf(pv[i].x, v0, t);
          t = fmaf(pv[i].y, v1, t);
          t = fmaf(pv[i].z, v2, t);
          t = fmaf(pv[i].w, v3, t);
          acc[i][j] = t;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * Sq + r) * H + h) * dv;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int n = tx + 16 * j;
      if (n < dv) orow[n] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KV, int dh, int dv,
                   float scale, int causal, cudaStream_t stream) {
  const int dhp = (dh + 3) / 4 * 4;
  const size_t bytes = sizeof(float) *
      (static_cast<size_t>(kBQ + kBK) * (dhp + 4) +
       static_cast<size_t>(kBK) * NV * 16 + static_cast<size_t>(kBQ) * kPS);
  auto kernel = flash_fwd_kernel<T, NV>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B * H));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, dh, dv,
      dhp, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KV, int dh, int dv,
                     float scale, int causal, cudaStream_t stream) {
  const int nv = (dv + 15) / 16;
  if (nv <= 1) {
    return launch<T, 1>(q, k, v, o, B, Sq, Sk, H, KV, dh, dv, scale, causal,
                        stream);
  }
  if (nv <= 2) {
    return launch<T, 2>(q, k, v, o, B, Sq, Sk, H, KV, dh, dv, scale, causal,
                        stream);
  }
  if (nv <= 4) {
    return launch<T, 4>(q, k, v, o, B, Sq, Sk, H, KV, dh, dv, scale, causal,
                        stream);
  }
  if (nv <= 8) {
    return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, KV, dh, dv, scale, causal,
                        stream);
  }
  return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, dh, dv, scale, causal,
                       stream);
}

}  // namespace

// q (B, Sq, H, dh), k (B, Sk, KV, dh), v (B, Sk, KV, dv), all contiguous
// and of one type (bf16 = 0: float32, 1: bfloat16); writes o (B, Sq, H, dv)
// of that type. H % KV == 0, 1 <= dh, dv <= 256, Sk >= 1.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int H, int KV, int dh, int dv,
                                   int bf16, float scale, int causal,
                                   void* stream) {
  if (B > 0 && Sq > 0 && H > 0) {
    if (Sk < 1 || KV < 1 || H % KV != 0 || dh < 1 || dh > 256 || dv < 1 ||
        dv > 256 || static_cast<int64_t>(B) * H > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, dh, dv,
                                       scale, causal, s)
             : dispatch<float>(q, k, v, o, B, Sq, Sk, H, KV, dh, dv, scale,
                               causal, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
