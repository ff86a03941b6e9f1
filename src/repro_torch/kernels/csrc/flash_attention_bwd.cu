// K9-bwd — the gradient of K9's attention:
//
//   given q (b, hq, sq, d), k, v (b, hkv, sk, d), K9's output o and its
//   per-row log-sum-exp lse (b, hq, sq), and the output's gradient dO:
//     D_i   = Σ_c dO[i,c] · O[i,c]
//     s_ij  = scale · q_i·k_j,  x_ij = cap·tanh(s_ij / cap) (softcap) + mask
//     P_ij  = exp(x_ij − lse_i)          (1/sk on a row with no valid key)
//     dV_j  = Σ_i P_ij dO_i              dP_ij = dO_i·v_j
//     dS_ij = P_ij (dP_ij − D_i) · (1 − tanh²(s_ij / cap))   (softcap)
//     dQ_i  = scale · Σ_j dS_ij k_j      dK_j  = scale · Σ_i dS_ij q_i
//   with dK and dV summed over the query heads of each kv head (GQA).
//
// Replaces no TPU kernel: the JAX package trains through plain JAX
// (`jax.value_and_grad` over `attention_reference` / `attention_chunked`),
// and no Pallas kernel of src/repro has a backward.  The port's training
// runs its attention forward through K9 (flash_attention.cu), and this is
// that forward's backward, the `torch.autograd.Function` of
// kernels/ops.py:flash.  What it computes is what `torch.autograd` of the
// plain `ref.flash_attention_ref` computes: the mask is an additive −1e30
// bias there (as in the JAX model's attention_reference), so a masked
// logit's P is exactly 0 on a row with a valid key, and a row with none
// softmaxes to the uniform row 1/sk, whose dS reaches q and k too.
//
// What bounds it on the H100: operations.  A live (query, key) pair costs
// the recomputed S and dP, then dV, dK and dQ: 10·d flops, 2.5x the
// forward's 4·d; at a RecurrentGemma-2B training microbatch (b = 1, hq =
// 10, MQA, s = 4096, window 2048, head_dim 256) 1.61·10^11 flops, 0.163 ms
// at the bf16 tensor cores' 989 TFLOP/s, against 92 MB (0.028 ms).
//
// Two routes, one per input dtype, as K9's forward:
//  * bf16 (the training path): tensor-core kernels, `mma.sync` m16n8k16
//    with f32 accumulators (namespace tc below); P and dS enter their
//    products split into two bf16 halves, so the result holds the f32
//    kernels' tolerance.  They recompute S and dP in both passes, and the
//    dK/dV pass computes them twice a key group (see tc), so they issue
//    24·d tensor-core flops a live pair;
//  * f32: CUDA-core kernels, f32 FMAs from shared memory, the first
//    version of this kernel (14·d flops a live pair).
//
// Deterministic (no float atomics), so a training run is bit-identical to
// itself, which the driver's restart relies on:
//  * flash_bwd_delta: one warp a row computes D_i (lane partials, then a
//    butterfly);
//  * dQ: one block a (b·hq row, query tile) loops over the kv tiles K9's
//    forward visits (every tile when a row of the q tile has no valid key)
//    and keeps dQ in registers;
//  * dK/dV: one block a (b·hq row, key tile) loops over the q tiles whose
//    rows see a key of the tile, and over those with no valid key (which
//    reach every key), keeping dK and dV in registers; with GQA it writes
//    each query head's part to f32 scratch, and
//  * flash_bwd_reduce sums a kv head's parts in head order and casts them.
//
// The CUDA-core kernels (flash_bwd_dq, flash_bwd_dkv) stage their tiles in
// shared memory in f32 (K and V rows padded to an odd float4 stride:
// conflict-free float4 reads across lanes), 32 queries by 32 keys (133 KB
// at head dim 256: one block an SM, so they may take 255 registers a
// thread, and do not spill); a warp owns 4 rows of the output tile and a
// lane the columns lane, lane + 32, …; the 4 x 32 dot products of S and dP
// a thread are float4 reads of a per-lane row against broadcast rows, and
// the products into the accumulators take P or dS from the lane that
// computed it by shuffle.
#include "common.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr float MASKED = -1e30f;
constexpr int BQ = 32;           // queries a tile
constexpr int BK = 32;           // keys a tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;           // output rows a warp (of a 32-row tile)
static_assert(WARPS * RPW == BQ && BQ == BK && BK == 32,
              "a lane is one row or key of a 32-wide tile");

struct Params {
  int hq, hkv, sq, sk, d;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(REPRO_FULL_MASK, x, off);
  return x;
}

__device__ __forceinline__ bool in_band(const Params& p, int qi, int kj) {
  return !((p.causal && qi < kj) || (p.has_window && qi - kj >= p.window));
}

// The first query row with no valid key (sq when none): K9's forward
// softmaxes such rows to the uniform row over every key.
__device__ __forceinline__ int first_empty_row(const Params& p) {
  if (!p.has_window) return p.sq;
  if (p.causal && p.window <= 0) return 0;
  return min(p.sq, max(0, p.sk - 1 + p.window));
}

// The kv tiles [t_lo, t_hi] (of bk keys) that hold a valid key for some row
// of the bq-query tile at q0 (all tiles when some row of it has none).
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int bq,
                                         int bk, int& t_lo, int& t_hi) {
  const int q_last = min(q0 + bq, p.sq) - 1;
  const int k_hi = p.causal ? min(q_last, p.sk - 1) : p.sk - 1;
  t_lo = 0;
  t_hi = (p.sk - 1) / bk;
  const bool empty_row = p.has_window && (q_last - p.window + 1 > k_hi);
  if (!empty_row) {
    t_hi = k_hi / bk;
    if (p.has_window) t_lo = max(0, q0 - p.window + 1) / bk;
  }
}

// Whether the bq-query tile at q0 holds a query that sees a key of
// [k0, k1], or a row with no valid key (which reaches every key).
__device__ __forceinline__ bool q_tile_live(const Params& p, int q0, int bq,
                                            int k0, int k1) {
  const int q1 = min(q0 + bq, p.sq) - 1;
  const int i_lo = p.causal ? k0 : 0;
  const int i_hi = p.has_window ? min(p.sq - 1, k1 + p.window - 1)
                                : p.sq - 1;
  return (q1 >= i_lo && q0 <= i_hi) || q1 >= first_empty_row(p);
}

// P and dS (with respect to the raw score s) of one (query, key) pair from
// its score s = scale·q·k, dP = dO·v, and the row's lse and D.
__device__ __forceinline__ void p_ds(const Params& p, float s, float dp,
                                     float lse, float dd, int qi, int kj,
                                     float& pv, float& dsv) {
  if (kj >= p.sk || qi >= p.sq) {
    pv = 0.0f;
    dsv = 0.0f;
    return;
  }
  float x = s, chain = 1.0f;
  if (p.has_softcap) {
    const float t = tanhf(s / p.softcap);
    x = p.softcap * t;
    chain = 1.0f - t * t;
  }
  if (!in_band(p, qi, kj)) x = MASKED;
  pv = lse <= 0.5f * MASKED ? 1.0f / (float)p.sk : expf(x - lse);
  dsv = pv * (dp - dd) * chain;
}

// rows [row0, row0 + 32) of a (rows, d) matrix -> a 32 x stride f32 tile,
// zero past `limit` rows and past d columns
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int limit, int d, int width,
                                      int stride) {
  for (int idx = threadIdx.x; idx < 32 * width; idx += THREADS) {
    const int r = idx / width, c = idx - r * width;
    const int row = row0 + r;
    dst[r * stride + c] =
        (row < limit && c < d) ? widen(src[(size_t)row * d + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, long long rows, int d) {
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* orow = o + row * d;
  const T* drow = dout + row * d;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) acc += widen(orow[c]) * widen(drow[c]);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// dQ: one block a (b·hq row g, 32-query tile)
template <typename T, int CPL>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, Params p) {
  constexpr int DV = 32 * CPL;
  constexpr int STRIDE = DV + 4;       // an odd float4 stride
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // BQ x STRIDE
  float* do_s = q_s + BQ * STRIDE;     // BQ x STRIDE
  float* k_s = do_s + BQ * STRIDE;     // BK x STRIDE
  float* v_s = k_s + BK * STRIDE;      // BK x STRIDE

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.y, q0 = blockIdx.x * BQ;
  const int rep = p.hq / p.hkv;
  const int kv = (g / p.hq) * p.hkv + (g % p.hq) / rep;
  const T* qg = q + (size_t)g * p.sq * p.d;
  const T* dog = dout + (size_t)g * p.sq * p.d;
  const T* kg = k + (size_t)kv * p.sk * p.d;
  const T* vg = v + (size_t)kv * p.sk * p.d;

  stage(q_s, qg, q0, p.sq, p.d, DV, STRIDE);
  stage(do_s, dog, q0, p.sq, p.d, DV, STRIDE);
  float row_lse[RPW], row_d[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + warp * RPW + r;
    row_lse[r] = qi < p.sq ? lse[(size_t)g * p.sq + qi] : 0.0f;
    row_d[r] = qi < p.sq ? delta[(size_t)g * p.sq + qi] : 0.0f;
  }
  float acc[RPW][CPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[r][t] = 0.0f;

  int t_lo, t_hi;
  kv_tiles(p, q0, BQ, BK, t_lo, t_hi);
  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the last tile's K and V are no longer read
    stage(k_s, kg, k0, p.sk, p.d, DV, STRIDE);
    stage(v_s, vg, k0, p.sk, p.d, DV, STRIDE);
    __syncthreads();

    // S and dP: lane owns key k0 + lane, for the warp's 4 rows
    float s[RPW], dp[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.0f;
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * STRIDE);
    const float4* vrow = reinterpret_cast<const float4*>(v_s + lane * STRIDE);
#pragma unroll 2
    for (int c4 = 0; c4 < DV / 4; ++c4) {
      const float4 kx = krow[c4], vx = vrow[c4];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int row = (warp * RPW + r) * STRIDE;
        const float4 qx = reinterpret_cast<const float4*>(q_s + row)[c4];
        const float4 dx = reinterpret_cast<const float4*>(do_s + row)[c4];
        s[r] = fmaf(qx.x, kx.x, s[r]);
        s[r] = fmaf(qx.y, kx.y, s[r]);
        s[r] = fmaf(qx.z, kx.z, s[r]);
        s[r] = fmaf(qx.w, kx.w, s[r]);
        dp[r] = fmaf(dx.x, vx.x, dp[r]);
        dp[r] = fmaf(dx.y, vx.y, dp[r]);
        dp[r] = fmaf(dx.z, vx.z, dp[r]);
        dp[r] = fmaf(dx.w, vx.w, dp[r]);
      }
    }
    float ds[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float pv;
      p_ds(p, s[r] * p.scale, dp[r], row_lse[r], row_d[r],
           q0 + warp * RPW + r, k0 + lane, pv, ds[r]);
    }
    // dQ += dS · K: lane j's dS is broadcast to the warp
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float kx[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) kx[t] = k_s[j * STRIDE + lane + 32 * t];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float dsj = __shfl_sync(REPRO_FULL_MASK, ds[r], j);
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[r][t] = fmaf(dsj, kx[t], acc[r][t]);
      }
    }
  }

  T* dqg = dq + (size_t)g * p.sq * p.d;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + warp * RPW + r;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      if (c < p.d) dqg[(size_t)qi * p.d + c] = narrow<T>(acc[r][t] * p.scale);
    }
  }
}

// dK and dV of one query head's share: one block a (b·hq row g, 32-key
// tile); writes dk/dv of g's kv head directly (rep == 1, in T) or g's part
// in f32 (dk_part/dv_part, (b·hq, sk, d)) for flash_bwd_reduce
template <typename T, int CPL>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv,
              float* __restrict__ dk_part, float* __restrict__ dv_part,
              Params p) {
  constexpr int DV = 32 * CPL;
  constexpr int STRIDE = DV + 4;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                   // BK x STRIDE
  float* v_s = k_s + BK * STRIDE;      // BK x STRIDE
  float* q_s = v_s + BK * STRIDE;      // BQ x STRIDE
  float* do_s = q_s + BQ * STRIDE;     // BQ x STRIDE

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.y, k0 = blockIdx.x * BK;
  const int rep = p.hq / p.hkv;
  const int kv = (g / p.hq) * p.hkv + (g % p.hq) / rep;
  const T* qg = q + (size_t)g * p.sq * p.d;
  const T* dog = dout + (size_t)g * p.sq * p.d;
  const T* kg = k + (size_t)kv * p.sk * p.d;
  const T* vg = v + (size_t)kv * p.sk * p.d;

  stage(k_s, kg, k0, p.sk, p.d, DV, STRIDE);
  stage(v_s, vg, k0, p.sk, p.d, DV, STRIDE);

  const int k1 = min(k0 + BK, p.sk) - 1;

  float dka[RPW][CPL], dva[RPW][CPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int t = 0; t < CPL; ++t) dka[r][t] = dva[r][t] = 0.0f;

  const int n_tiles = (p.sq + BQ - 1) / BQ;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * BQ;
    if (!q_tile_live(p, q0, BQ, k0, k1)) continue;
    __syncthreads();  // the last tile's Q and dO are no longer read
    stage(q_s, qg, q0, p.sq, p.d, DV, STRIDE);
    stage(do_s, dog, q0, p.sq, p.d, DV, STRIDE);
    __syncthreads();

    // S and dP: lane owns query q0 + lane, for the warp's 4 keys
    const int qi = q0 + lane;
    const float row_lse = qi < p.sq ? lse[(size_t)g * p.sq + qi] : 0.0f;
    const float row_d = qi < p.sq ? delta[(size_t)g * p.sq + qi] : 0.0f;
    float s[RPW], dp[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.0f;
    const float4* qrow = reinterpret_cast<const float4*>(q_s + lane * STRIDE);
    const float4* drow = reinterpret_cast<const float4*>(do_s + lane * STRIDE);
#pragma unroll 2
    for (int c4 = 0; c4 < DV / 4; ++c4) {
      const float4 qx = qrow[c4], dx = drow[c4];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int row = (warp * RPW + r) * STRIDE;
        const float4 kx = reinterpret_cast<const float4*>(k_s + row)[c4];
        const float4 vx = reinterpret_cast<const float4*>(v_s + row)[c4];
        s[r] = fmaf(qx.x, kx.x, s[r]);
        s[r] = fmaf(qx.y, kx.y, s[r]);
        s[r] = fmaf(qx.z, kx.z, s[r]);
        s[r] = fmaf(qx.w, kx.w, s[r]);
        dp[r] = fmaf(dx.x, vx.x, dp[r]);
        dp[r] = fmaf(dx.y, vx.y, dp[r]);
        dp[r] = fmaf(dx.z, vx.z, dp[r]);
        dp[r] = fmaf(dx.w, vx.w, dp[r]);
      }
    }
    float pv[RPW], ds[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
      p_ds(p, s[r] * p.scale, dp[r], row_lse, row_d, qi,
           k0 + warp * RPW + r, pv[r], ds[r]);

    // dV += Pᵀ dO, dK += dSᵀ Q: lane m's P and dS are broadcast to the warp
#pragma unroll 4
    for (int m = 0; m < BQ; ++m) {
      float qx[CPL], dx[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        qx[t] = q_s[m * STRIDE + lane + 32 * t];
        dx[t] = do_s[m * STRIDE + lane + 32 * t];
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pm = __shfl_sync(REPRO_FULL_MASK, pv[r], m);
        const float dsm = __shfl_sync(REPRO_FULL_MASK, ds[r], m);
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          dva[r][t] = fmaf(pm, dx[t], dva[r][t]);
          dka[r][t] = fmaf(dsm, qx[t], dka[r][t]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int kj = k0 + warp * RPW + r;
    if (kj >= p.sk) continue;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      if (c >= p.d) continue;
      const float dkv = dka[r][t] * p.scale;
      if (rep == 1) {
        const size_t at = ((size_t)kv * p.sk + kj) * p.d + c;
        dk[at] = narrow<T>(dkv);
        dv[at] = narrow<T>(dva[r][t]);
      } else {
        const size_t at = ((size_t)g * p.sk + kj) * p.d + c;
        dk_part[at] = dkv;
        dv_part[at] = dva[r][t];
      }
    }
  }
}

// dk/dv (b·hkv, sk, d) = Σ over a kv head's rep query heads of the parts,
// in head order
template <typename T>
__global__ void flash_bwd_reduce(const float* __restrict__ dk_part,
                                 const float* __restrict__ dv_part,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 long long n, long long per_head, int rep) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long head = i / per_head, at = i - head * per_head;
  const float* kp = dk_part + head * rep * per_head + at;
  const float* vp = dv_part + head * rep * per_head + at;
  float sk = 0.0f, sv = 0.0f;
  for (int r = 0; r < rep; ++r) {
    sk += kp[(size_t)r * per_head];
    sv += vp[(size_t)r * per_head];
  }
  dk[i] = narrow<T>(sk);
  dv[i] = narrow<T>(sv);
}

template <typename T, int CPL>
int launch_cpl(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, float* dk_part, float* dv_part, int b,
               const Params& p, cudaStream_t stream) {
  constexpr int STRIDE = 32 * CPL + 4;
  const size_t smem = sizeof(float) * (size_t)(2 * BQ + 2 * BK) * STRIDE;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq<T, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkv<T, CPL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int bh = b * p.hq;
  flash_bwd_dq<T, CPL><<<dim3((p.sq + BQ - 1) / BQ, bh), THREADS, smem,
                      stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, p);
  REPRO_LAUNCH_CHECK();
  flash_bwd_dkv<T, CPL><<<dim3((p.sk + BK - 1) / BK, bh), THREADS, smem,
                       stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, dk_part, dv_part, p);
  REPRO_LAUNCH_CHECK();
  return 0;
}

// ---------------------------------------------------------------------------
// The tensor-core kernels (bf16 inputs): `mma.sync` m16n8k16, bf16 operands
// and f32 accumulators, 64-query by 64-key tiles staged in shared memory as
// bf16 rows padded by 16 bytes (conflict-free fragment loads and
// `ldmatrix`), head dims padded to 64, 128 or 256.
//
//  * S = Q·Kᵀ and dP = dO·Vᵀ read q, k, v and dO as they are: bf16 × bf16
//    products are exact in f32, so these match the CUDA-core kernels' up to
//    the order of the sums;
//  * P and dS enter the next products split in two, hi = bf16(x) and lo =
//    bf16(x − hi), as K9's forward splits its P (|x − hi − lo| <= 2^-16·|x|):
//    dV += P_hiᵀ·dO + P_loᵀ·dO, dK += dS_hiᵀ·Q + dS_loᵀ·Q, dQ += dS_hi·K +
//    dS_lo·K, which holds the f32 kernel's tolerance;
//  * the accumulator of S and dP is, warp by warp, the m16n8 C fragment,
//    which is element for element the A fragment of the next product, so P
//    and dS go from registers into it; the second operand (dO, Q, K as
//    k-major) comes from shared memory through `ldmatrix.trans`;
//  * flash_bwd_dq_tc: a block of 4 warps owns 64 queries (a warp 16, with
//    their whole dQ row), looping over K9's kv tiles;
//  * flash_bwd_dkv_tc: a block of 8 warps owns 64 keys; a warp 16 keys and
//    half the head's columns of dK and dV (the two warps of a key group
//    both compute its S and dP: registers hold 2 x 64 x 128 f32
//    accumulators a warp pair, not 2 x 64 x 256).
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64, BK = 64;

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragment (16 k x 8 n) of rows [r0, r0 + 16), columns [c0, c0 + 8)
// of a row-major (k, n) bf16 tile with row stride `ld`: the transposed 8x8
// loads give each thread (k = 2t, 2t + 1; n = g) and (k = 2t + 8, 2t + 9)
__device__ __forceinline__ void ldsm_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* tile, int r0, int c0,
                                       int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* row = tile + (size_t)(r0 + (lane & 15)) * ld + c0;
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1) : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the A fragment (16 rows x 16 k) at (r0, k0) of a row-major bf16 tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int k0, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = tile + (size_t)(r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> hi = bf16(x, y), lo = bf16(x − hi, y − hi); the lower half
// holds the lower column
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// the A fragments (hi and lo) of k-step kc (16 columns) of a 16 x 64 f32
// accumulator c[8][4] (8 n-tiles of 8 columns)
__device__ __forceinline__ void split_a(const float (&c)[8][4], int kc,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c[2 * kc][0], c[2 * kc][1], hi[0], lo[0]);
  split(c[2 * kc][2], c[2 * kc][3], hi[1], lo[1]);
  split(c[2 * kc + 1][0], c[2 * kc + 1][1], hi[2], lo[2]);
  split(c[2 * kc + 1][2], c[2 * kc + 1][3], hi[3], lo[3]);
}

// rows [row0, row0 + 64) of a (rows, d) bf16 matrix -> a 64 x D tile with
// row stride D + 8; rows at or past `limit` and columns at or past d zero
template <int D, int THREADS_>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int limit, int d,
                                          bool vec) {
  constexpr int LD = D + 8, CH = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS_) {
    const int r = idx / CH, c = (idx - r * CH) * 8;
    const int row = row0 + r;
    bf16* out = dst + r * LD + c;
    if (vec) {
      uint4 x = make_uint4(0, 0, 0, 0);
      if (row < limit && c < d)
        x = *reinterpret_cast<const uint4*>(src + (size_t)row * d + c);
      *reinterpret_cast<uint4*>(out) = x;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = (row < limit && c + e < d) ? src[(size_t)row * d + c + e]
                                            : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                Params p, int vec) {
  constexpr int LD = D + 8, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // 64 x LD each
  bf16* do_s = q_s + BQ * LD;
  bf16* k_s = do_s + BQ * LD;
  bf16* v_s = k_s + BK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int gi = blockIdx.y, q0 = blockIdx.x * BQ;
  const int rep = p.hq / p.hkv;
  const int kv = (gi / p.hq) * p.hkv + (gi % p.hq) / rep;
  const bf16* kg = k + (size_t)kv * p.sk * p.d;
  const bf16* vg = v + (size_t)kv * p.sk * p.d;

  load_tile<D, 128>(q_s, q + (size_t)gi * p.sq * p.d, q0, p.sq, p.d, vec);
  load_tile<D, 128>(do_s, dout + (size_t)gi * p.sq * p.d, q0, p.sq, p.d,
                    vec);
  const int r0 = warp * 16;  // this warp's rows of the tile
  float row_lse[2], row_d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    row_lse[i] = qi < p.sq ? lse[(size_t)gi * p.sq + qi] : 0.0f;
    row_d[i] = qi < p.sq ? delta[(size_t)gi * p.sq + qi] : 0.0f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  int t_lo, t_hi;
  kv_tiles(p, q0, BQ, BK, t_lo, t_hi);
  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the last tile's K and V are no longer read
    load_tile<D, 128>(k_s, kg, k0, p.sk, p.d, vec);
    load_tile<D, 128>(v_s, vg, k0, p.sk, p.d, vec);
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ, 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a(aq, q_s, r0, kk * 16, LD);
      frag_a(ao, do_s, r0, kk * 16, LD);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* kr = k_s + (n * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* vr = v_s + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma(s[n], aq, ld32(kr), ld32(kr + 8));
        mma(dp[n], ao, ld32(vr), ld32(vr + 8));
      }
    }
    // dS in place of S
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv;
        p_ds(p, s[n][e] * p.scale, dp[n][e], row_lse[e >> 1], row_d[e >> 1],
             q0 + r0 + g + 8 * (e >> 1), k0 + n * 8 + 2 * t + (e & 1), pv,
             s[n][e]);
      }
    // dQ += dS_hi·K + dS_lo·K
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t hi[4], lo[4];
      split_a(s, kc, hi, lo);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_b(b0, b1, k_s, kc * 16, n * 8, LD);
        mma(acc[n], hi, b0, b1);
        mma(acc[n], lo, b0, b1);
      }
    }
  }

  bf16* dqg = dq + (size_t)gi * p.sq * p.d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < p.d)
        dqg[(size_t)qi * p.d + c] = __float2bfloat16_rn(acc[n][2 * i] * p.scale);
      if (c + 1 < p.d)
        dqg[(size_t)qi * p.d + c + 1] =
            __float2bfloat16_rn(acc[n][2 * i + 1] * p.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, float* __restrict__ dk_part,
                 float* __restrict__ dv_part, Params p, int vec) {
  constexpr int LD = D + 8, HALF = D / 2, NT = HALF / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // 64 x LD each
  bf16* v_s = k_s + BK * LD;
  bf16* q_s = v_s + BK * LD;
  bf16* do_s = q_s + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * LD);  // BQ
  float* d_s = lse_s + BQ;                                  // BQ

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;       // this warp's 16 keys of the tile
  const int c0 = (warp >> 2) * HALF;    // and its half of the columns
  const int gi = blockIdx.y, k0 = blockIdx.x * BK;
  const int rep = p.hq / p.hkv;
  const int kv = (gi / p.hq) * p.hkv + (gi % p.hq) / rep;
  const bf16* qg = q + (size_t)gi * p.sq * p.d;
  const bf16* dog = dout + (size_t)gi * p.sq * p.d;

  load_tile<D, 256>(k_s, k + (size_t)kv * p.sk * p.d, k0, p.sk, p.d, vec);
  load_tile<D, 256>(v_s, v + (size_t)kv * p.sk * p.d, k0, p.sk, p.d, vec);
  const int k1 = min(k0 + BK, p.sk) - 1;

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  const int n_tiles = (p.sq + BQ - 1) / BQ;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * BQ;
    if (!q_tile_live(p, q0, BQ, k0, k1)) continue;
    __syncthreads();  // the last tile's Q, dO, lse and D are no longer read
    load_tile<D, 256>(q_s, qg, q0, p.sq, p.d, vec);
    load_tile<D, 256>(do_s, dog, q0, p.sq, p.d, vec);
    if (threadIdx.x < BQ) {
      const int qi = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < p.sq ? lse[(size_t)gi * p.sq + qi] : 0.0f;
      d_s[threadIdx.x] = qi < p.sq ? delta[(size_t)gi * p.sq + qi] : 0.0f;
    }
    __syncthreads();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, 16 keys x 64 queries a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, k_s, r0, kk * 16, LD);
      frag_a(av, v_s, r0, kk * 16, LD);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* qr = q_s + (n * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* dr = do_s + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma(s[n], ak, ld32(qr), ld32(qr + 8));
        mma(dp[n], av, ld32(dr), ld32(dr + 8));
      }
    }
    // Pᵀ in place of Sᵀ, dSᵀ in place of dPᵀ
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        float pv, dsv;
        p_ds(p, s[n][e] * p.scale, dp[n][e], lse_s[col], d_s[col], q0 + col,
             k0 + r0 + g + 8 * (e >> 1), pv, dsv);
        s[n][e] = pv;
        dp[n][e] = dsv;
      }
    // dV += Pᵀ·dO and dK += dSᵀ·Q, each operand split in two
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_a(s, kc, ph, pl);
      split_a(dp, kc, dh, dl);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_b(b0, b1, do_s, kc * 16, c0 + n * 8, LD);
        mma(dva[n], ph, b0, b1);
        mma(dva[n], pl, b0, b1);
        ldsm_b(b0, b1, q_s, kc * 16, c0 + n * 8, LD);
        mma(dka[n], dh, b0, b1);
        mma(dka[n], dl, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + r0 + g + 8 * i;
    if (kj >= p.sk) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + n * 8 + 2 * t + e;
        if (c >= p.d) continue;
        const float dkv = dka[n][2 * i + e] * p.scale;
        const float dvv = dva[n][2 * i + e];
        if (rep == 1) {
          const size_t at = ((size_t)kv * p.sk + kj) * p.d + c;
          dk[at] = __float2bfloat16_rn(dkv);
          dv[at] = __float2bfloat16_rn(dvv);
        } else {
          const size_t at = ((size_t)gi * p.sk + kj) * p.d + c;
          dk_part[at] = dkv;
          dv_part[at] = dvv;
        }
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, float* dk_part, float* dv_part, int b, const Params& p,
           int vec, cudaStream_t stream) {
  const size_t tiles = sizeof(bf16) * (size_t)(2 * BQ + 2 * BK) * (D + 8);
  const size_t smem_dkv = tiles + 2 * BQ * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tiles);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkv_tc<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_dkv);
  if (e != cudaSuccess) return (int)e;
  const int bh = b * p.hq;
  flash_bwd_dq_tc<D><<<dim3((p.sq + BQ - 1) / BQ, bh), 128, tiles, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dq, p, vec);
  REPRO_LAUNCH_CHECK();
  flash_bwd_dkv_tc<D><<<dim3((p.sk + BK - 1) / BK, bh), 256, smem_dkv,
                        stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dk, (bf16*)dv, dk_part, dv_part, p, vec);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace tc

// every kernel of one backward: D, then dQ and dK/dV (the tensor-core
// kernels for bf16, the CUDA-core ones for f32), then the GQA parts' sum
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, void* dk_part, void* dv_part, int b,
           const Params& p, int vec, cudaStream_t stream) {
  const long long rows = (long long)b * p.hq * p.sq;
  flash_bwd_delta<T><<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0,
                    stream>>>((const T*)o, (const T*)dout, (float*)delta,
                              rows, p.d);
  REPRO_LAUNCH_CHECK();
  const float* l = (const float*)lse;
  const float* dd = (const float*)delta;
  float* kp = (float*)dk_part;
  float* vp = (float*)dv_part;
  int rc;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const auto run = p.d <= 64 ? tc::launch<64>
                     : p.d <= 128 ? tc::launch<128> : tc::launch<256>;
    rc = run(q, k, v, dout, l, dd, dq, dk, dv, kp, vp, b, p, vec, stream);
  } else switch ((p.d + 31) / 32) {
    case 1: rc = launch_cpl<T, 1>(q, k, v, dout, l, dd, dq, dk, dv, kp, vp, b, p, stream); break;
    case 2: rc = launch_cpl<T, 2>(q, k, v, dout, l, dd, dq, dk, dv, kp, vp, b, p, stream); break;
    case 3: rc = launch_cpl<T, 3>(q, k, v, dout, l, dd, dq, dk, dv, kp, vp, b, p, stream); break;
    case 4: rc = launch_cpl<T, 4>(q, k, v, dout, l, dd, dq, dk, dv, kp, vp, b, p, stream); break;
    case 5: rc = launch_cpl<T, 5>(q, k, v, dout, l, dd, dq, dk, dv, kp, vp, b, p, stream); break;
    case 6: rc = launch_cpl<T, 6>(q, k, v, dout, l, dd, dq, dk, dv, kp, vp, b, p, stream); break;
    case 7: rc = launch_cpl<T, 7>(q, k, v, dout, l, dd, dq, dk, dv, kp, vp, b, p, stream); break;
    case 8: rc = launch_cpl<T, 8>(q, k, v, dout, l, dd, dq, dk, dv, kp, vp, b, p, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const int rep = p.hq / p.hkv;
  if (rep > 1) {
    const long long per_head = (long long)p.sk * p.d;
    const long long n = (long long)b * p.hkv * per_head;
    flash_bwd_reduce<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        kp, vp, (T*)dk, (T*)dv, n, per_head, rep);
    REPRO_LAUNCH_CHECK();
  }
  return 0;
}

bool valid(int b, int hq, int hkv, int sk, int d) {
  return d >= 1 && d <= 256 && sk >= 1 && hkv >= 1 && hq % hkv == 0 &&
         (long long)b * hq <= 65535;
}

}  // namespace

// q, o, dout, dq: (b, hq, sq, d); k, v, dk, dv: (b, hkv, sk, d); all
// contiguous, of one dtype (`bf16` 1: bf16, 0: f32); lse, delta: (b, hq, sq)
// f32 (delta is scratch); with hq > hkv, dk_part and dv_part are (b, hq,
// sk, d) f32 scratch (unused, may be null, when hq == hkv).  1 <= d <= 256,
// hq % hkv == 0, sk >= 1, -sk <= window <= sq when has_window (the wrapper
// clamps it, as K9's).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* dk_part, void* dv_part, int bf16, int b, int hq, int hkv,
    int sq, int sk, int d, int causal, int has_window, int window,
    int has_softcap, float softcap, float scale, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (!valid(b, hq, hkv, sk, d)) return (int)cudaErrorInvalidValue;
  const Params p{hq, hkv, sq, sk, d, causal, has_window, window, has_softcap,
                 softcap, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const int vec = d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k |
                                   (uintptr_t)v | (uintptr_t)dout) % 16 == 0;
    return launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 dk_part, dv_part, b, p, vec, st);
  }
  return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, dk_part,
                       dv_part, b, p, 0, st);
}
