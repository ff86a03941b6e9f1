// K9 — forward attention with an online softmax, on the CUDA cores:
//
//   o[g, i] = Σ_j softmax_j(mask(cap·tanh(scale·q[g,i]·k[kv(g),j] / cap))) · v[kv(g), j]
//
// with GQA (kv(g) = (g / hq)·hkv + (g % hq) / rep, rep = hq / hkv), a causal
// mask, a sliding window ((i − j) < window) and an optional logit softcap;
// masked logits are −1e30 (not −inf), the output is acc / max(l, 1e−30) in
// q's dtype, and every sum is f32.
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention` /
// `_flash_kernel`, the TPU kernel that carries (m, l, acc) in VMEM scratch
// across an in-order KV grid axis, one (b·hq row, q tile, kv tile) grid step
// at a time, over every kv tile of the row.
//
// What bounds it on the H100: operations.  At the prefill shape of
// RecurrentGemma-2B (b = 2, hq = 10, MQA, s = 4096, window 2048, head_dim
// 256) the live (query, key) pairs are 6.29 M a head, 4·d flops each:
// 1.29·10^11 flops a layer, 0.13 ms at the 989 TFLOP/s of bf16 tensor
// cores, against 92 MB of q, k, v and o (0.027 ms at 3.35 TB/s).  This
// first kernel runs in f32 on the CUDA cores (67 TFLOP/s peak), as the
// Pallas body computes (inputs cast to f32 at load, f32 dots): bf16
// mma/wgmma with a bf16 P is a later redesign.
//
// Design:
//  * a block (8 warps) owns one (b·hq row, 64-query tile) and loops over
//    32-key tiles inside, carrying (m, l, acc) in registers: each warp owns
//    8 query rows, each lane one key of the tile for the scores and the
//    columns lane, lane + 32, … of the output (acc is 8 × d/32 a thread);
//    the TPU's sequential kv grid axis becomes this loop;
//  * GQA by index: the block reads its kv row through kv(g), as the TPU
//    kernel's index map does, and no repeated head is materialized
//    (RecurrentGemma has rep = 10);
//  * only the kv tiles that hold a valid key for some row of the q tile
//    are visited: none past the causal diagonal, none wholly outside the
//    window (at the prefill shape, at most 2,144 of 4,096 keys a q tile:
//    67 tiles of 32).  This is exact: once a tile with a valid key has set
//    a row's running max m, a masked logit's exp(−1e30 − m) is 0 in f32,
//    and the terms a row gathered before its first valid key are
//    multiplied by exp(−1e30 − m) = 0.  A q tile with a row that has no
//    valid key at all (a causal window of 0 or less, or a window that
//    starts past the last key) visits every tile, so that row softmaxes to
//    the uniform row, as the TPU kernel's;
//  * the q tile is staged once in shared memory (f32, times scale); each
//    kv tile's K (rows padded to an odd float4 stride: conflict-free float4
//    reads across lanes) and V (lane-strided columns) are staged per tile;
//    q rows are broadcast float4 reads.  At head_dim 256 that is 128.5 KB
//    of dynamic shared memory (cudaFuncSetAttribute above 48 KB) and one
//    block an SM;
//  * row max and row sum are warp shuffles (a warp owns its rows whole);
//    P·V broadcasts each lane's p to the warp with a shuffle;
//  * ragged sq and sk are masked in the kernel (out-of-range keys are −inf,
//    so they drop out even of an all-masked row; out-of-range queries are
//    not stored), and any head_dim up to 256 is zero-padded to a multiple
//    of 4 (the TPU kernel asserts divisibility).  The template on d/32
//    rounded up sizes the accumulator.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;  // query rows per warp (8)
constexpr float MASKED = -1e30f;

struct Params {
  int hq, hkv, sq, sk, d;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(REPRO_FULL_MASK, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(REPRO_FULL_MASK, x, off);
  return x;
}

template <typename T, int CPL>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Params p) {
  constexpr int DV = 32 * CPL;        // V row width: the lanes' columns
  extern __shared__ __align__(16) float smem[];
  const int dq = (p.d + 3) & ~3;      // q and K row width, float4-aligned
  const int ks = dq + 4;              // K row stride: an odd float4 offset
  float* q_s = smem;                  // BQ x dq
  float* k_s = q_s + BQ * dq;         // BK x ks
  float* v_s = k_s + BK * ks;         // BK x DV

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int rep = p.hq / p.hkv;
  const int kv = (g / p.hq) * p.hkv + (g % p.hq) / rep;
  const T* qg = q + (size_t)g * p.sq * p.d;
  const T* kg = k + (size_t)kv * p.sk * p.d;
  const T* vg = v + (size_t)kv * p.sk * p.d;
  T* og = o + (size_t)g * p.sq * p.d;

  // the q tile in f32, times scale (as the TPU kernel scales q), padded
  for (int r = warp; r < BQ; r += WARPS) {
    const int qi = q0 + r;
    for (int c = lane; c < dq; c += 32)
      q_s[r * dq + c] = (qi < p.sq && c < p.d)
          ? to_f32(qg[(size_t)qi * p.d + c]) * p.scale : 0.0f;
  }

  // the kv tiles that hold a valid key for some row of this q tile
  const int q_last = min(q0 + BQ, p.sq) - 1;
  const int k_hi = p.causal ? min(q_last, p.sk - 1) : p.sk - 1;
  int t_lo = 0, t_hi = (p.sk - 1) / BK;
  const bool empty_row = p.has_window && (q_last - p.window + 1 > k_hi);
  if (!empty_row) {
    t_hi = k_hi / BK;
    if (p.has_window) t_lo = max(0, q0 - p.window + 1) / BK;
  }

  float m[RPW], l[RPW], acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = MASKED;
    l[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[i][t] = 0.0f;
  }

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the last tile's K and V are no longer read
    for (int r = warp; r < BK; r += WARPS) {
      const int kj = k0 + r;
      const bool in = kj < p.sk;
      for (int c = lane; c < dq; c += 32)
        k_s[r * ks + c] = (in && c < p.d)
            ? to_f32(kg[(size_t)kj * p.d + c]) : 0.0f;
      for (int c = lane; c < DV; c += 32)
        v_s[r * DV + c] = (in && c < p.d)
            ? to_f32(vg[(size_t)kj * p.d + c]) : 0.0f;
    }
    __syncthreads();

    // scores: lane owns key k0 + lane, for the warp's 8 rows
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.0f;
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * ks);
#pragma unroll 2
    for (int c4 = 0; c4 < dq / 4; ++c4) {
      const float4 kx = krow[c4];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qx =
            reinterpret_cast<const float4*>(q_s + (warp * RPW + i) * dq)[c4];
        s[i] = fmaf(qx.x, kx.x, s[i]);
        s[i] = fmaf(qx.y, kx.y, s[i]);
        s[i] = fmaf(qx.z, kx.z, s[i]);
        s[i] = fmaf(qx.w, kx.w, s[i]);
      }
    }

    // softcap, then the mask; the online softmax, row by row
    const int kj = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int qi = q0 + warp * RPW + i;
      float x = s[i];
      if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
      if (kj >= p.sk)
        x = -INFINITY;
      else if ((p.causal && qi < kj) ||
               (p.has_window && qi - kj >= p.window))
        x = MASKED;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float alpha = expf(m[i] - m_new);
      const float e = expf(x - m_new);
      l[i] = l[i] * alpha + warp_sum(e);
      m[i] = m_new;
      s[i] = e;
#pragma unroll
      for (int t = 0; t < CPL; ++t) acc[i][t] *= alpha;
    }

    // acc += P · V: lane j's p is broadcast to the warp
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vx[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) vx[t] = v_s[j * DV + lane + 32 * t];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pj = __shfl_sync(REPRO_FULL_MASK, s[i], j);
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[i][t] = fmaf(pj, vx[t], acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qi = q0 + warp * RPW + i;
    if (qi >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      if (c < p.d) store(og + (size_t)qi * p.d + c, acc[i][t] / den);
    }
  }
}

template <typename T, int CPL>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           const Params& p, cudaStream_t stream) {
  const int dq = (p.d + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)BQ * dq +
                                       (size_t)BK * (dq + 4) +
                                       (size_t)BK * 32 * CPL);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.sq + BQ - 1) / BQ, bh);
  flash_kernel<T, CPL><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, p);
  REPRO_LAUNCH_CHECK();
  return 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             const Params& p, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, bh, p, stream);
    case 2: return launch<T, 2>(q, k, v, o, bh, p, stream);
    case 3: return launch<T, 3>(q, k, v, o, bh, p, stream);
    case 4: return launch<T, 4>(q, k, v, o, bh, p, stream);
    case 5: return launch<T, 5>(q, k, v, o, bh, p, stream);
    case 6: return launch<T, 6>(q, k, v, o, bh, p, stream);
    case 7: return launch<T, 7>(q, k, v, o, bh, p, stream);
    case 8: return launch<T, 8>(q, k, v, o, bh, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (b, hq, sq, d); k, v: (b, hkv, sk, d); all contiguous, one dtype
// (f32, or bf16 when bf16 != 0); 1 <= d <= 256, hq % hkv == 0, sk >= 1,
// -sk <= window <= sq when has_window (the wrapper clamps it).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int hq,
                                     int hkv, int sq, int sk, int d, int bf16,
                                     int causal, int has_window, int window,
                                     int has_softcap, float softcap,
                                     float scale, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (d < 1 || d > 256 || sk < 1 || hkv < 1 || hq % hkv != 0 ||
      (long long)b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{hq, hkv, sq, sk, d, causal, has_window, window, has_softcap,
                 softcap, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, b * hq, p, st)
              : dispatch<float>(q, k, v, o, b * hq, p, st);
}
