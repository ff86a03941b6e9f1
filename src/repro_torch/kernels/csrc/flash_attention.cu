// K9 — forward attention with an online softmax:
//
//   o[g, i] = Σ_j softmax_j(mask(cap·tanh(scale·q[g,i]·k[kv(g),j] / cap))) · v[kv(g), j]
//
// with GQA (kv(g) = (g / hq)·hkv + (g % hq) / rep, rep = hq / hkv), a causal
// mask, a sliding window ((i − j) < window) and an optional logit softcap;
// masked logits are −1e30 (not −inf), the output is acc / max(l, 1e−30) in
// q's dtype, and every sum is f32.  When asked (a non-null `lse`), each row
// also writes the log-sum-exp of its masked logits, m + log(l) in f32 from
// the running max and sum its softmax used (the backward, K9-bwd in
// flash_attention_bwd.cu, recomputes P from it; a row with no valid key
// writes −1e30).  The prefill passes none.
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention` /
// `_flash_kernel`, the TPU kernel that carries (m, l, acc) in VMEM scratch
// across an in-order KV grid axis, one (b·hq row, q tile, kv tile) grid step
// at a time, over every kv tile of the row.  The TPU kernel is f32 from end
// to end: q, k and v cast to f32, f32 dots, an f32 p in P·V.
//
// Two kernels, one per input dtype:
//
//  * flash_kernel_tc (bf16 q, k, v: the prefill's path) — on the tensor
//    cores, `wgmma.mma_async` m64n64k16 with bf16 operands and f32
//    accumulators;
//  * flash_kernel (f32 q, k, v) — on the CUDA cores in f32, the first
//    version of this kernel, kept for f32 inputs (a bf16 split of f32 q and
//    k would not hold the scores to f32).
//
// What bounds it on the H100: operations.  At the prefill shape of
// RecurrentGemma-2B (b = 2, hq = 10, MQA, s = 4096, window 2048, head_dim
// 256) the live (query, key) pairs are 6.29 M a head, 4·d flops each:
// 1.29·10^11 flops a layer, 0.13 ms at the 989 TFLOP/s of bf16 tensor
// cores, against 92 MB of q, k, v and o (0.027 ms at 3.35 TB/s).  The f32
// kernel runs at the 67 TFLOP/s of the CUDA cores (60x the bound).  The
// tensor-core kernel does 6·d flops a live pair (the split below), and the
// softmax between its two products (exp, masks, the split) runs on the
// CUDA cores while the tensor cores wait: each warpgroup waits for its S
// before the softmax and for its P·V before the next tile, so the
// products of one warpgroup overlap only the other warpgroup's work.
//
// The tensor-core kernel's numbers (why it holds the f32 kernel's
// tolerance):
//  * S = Q·Kᵀ: bf16 × bf16 products are exact in f32 and accumulate in f32,
//    so the scores differ from the f32 kernel's only in summation order.
//    `scale` multiplies the f32 scores after the product (q is never scaled
//    in bf16, which would round it whenever scale is not a power of two);
//    softcap, mask, row max, exp and the row sum l are f32, as before.
//  * P·V with P split in two: P_hi = bf16(p), P_lo = bf16(p − P_hi), and
//    acc += P_hi·V + P_lo·V, two products into one f32 accumulator.  V is
//    bf16, so exact; |p − P_hi − P_lo| ≤ 2^-16·p, so the output is within
//    about 1.5e-5·max|v| of an f32 P·V (a single bf16 P would give 2^-8·p:
//    about 1e-3 on a row whose output nearly cancels).  The split costs one
//    more product per P·V step: 6·d flops a live pair in place of 4·d.
//
// Its design (head_dim 256):
//  * a block of two warpgroups (8 warps) owns one (b·hq row, 128-query
//    tile); a warpgroup owns 64 query rows, a warp 16 of them whole, so the
//    row max and row sum are two shuffles in a quad;
//  * S (64 × 64 keys a warpgroup) is head_dim / 16 `wgmma`s with Q and K
//    both read from shared memory (K-major); the accumulator's layout is,
//    warp by warp, the m16n8 C fragment, and that is element for element
//    the register A fragment of the next product, so the split P goes
//    straight from S's registers into P·V;
//  * P·V is, for each 16 keys, two `wgmma`s (P_hi, P_lo) into each of the
//    four 64-column blocks of the output, A from registers, V read from
//    shared memory MN-major (the instruction transposes it).  The split P
//    of the whole 64-key tile stays in registers until those products are
//    done;
//  * registers: the f32 output accumulator is 64 × 256 a warpgroup, 128 a
//    thread; S adds 32 and the split P 32: 237 a thread, no spill (the
//    first tensor-core version, `mma.sync` with ldmatrix fragments of K
//    and V, needed 255 and spilled);
//  * shared memory in the 128-byte swizzle the descriptors name: each
//    64-column block of a tile is rows of 128 bytes, the 16-byte chunk c of
//    row r stored at chunk c ^ (r % 8), 8-row groups 1024 bytes apart; a
//    k step inside a row is a 32-byte offset of the descriptor's start.
//    Q 64 KB, K and V double-buffered 2 × 2 × 32 KB, loaded by `cp.async`
//    (the next tile while this one is computed) and fenced to the tensor
//    cores' proxy before a barrier: 192 KB and one block an SM; the grid
//    at the prefill shape is 20 × 32 = 640 blocks;
//  * head dims are padded in shared memory to 64, 128 or 256 (one
//    instantiation each); a head_dim that is not a multiple of 8, or a
//    pointer that is not 16-byte aligned, loads through plain stores
//    instead of `cp.async` (same layout, zero-filled).
//
// Shared by both kernels:
//  * GQA by index: the block reads its kv row through kv(g), as the TPU
//    kernel's index map does, and no repeated head is materialized
//    (RecurrentGemma has rep = 10);
//  * only the kv tiles that hold a valid key for some row of the q tile
//    are visited: none past the causal diagonal, none wholly outside the
//    window.  This is exact: once a tile with a valid key has set a row's
//    running max m, a masked logit's exp(−1e30 − m) is 0 in f32, and the
//    terms a row gathered before its first valid key are multiplied by
//    exp(−1e30 − m) = 0.  A q tile with a row that has no valid key at all
//    (a causal window of 0 or less, or a window that starts past the last
//    key) visits every tile, so that row softmaxes to the uniform row, as
//    the TPU kernel's;
//  * ragged sq and sk are masked in the kernel (out-of-range keys are −inf,
//    so they drop out even of an all-masked row; out-of-range queries are
//    not stored), and any head_dim up to 256 is zero-padded (the TPU kernel
//    asserts divisibility).
//
// The f32 kernel's design: a block (8 warps) owns one (b·hq row, 64-query
// tile) and loops over 32-key tiles, carrying (m, l, acc) in registers:
// each warp owns 8 query rows, each lane one key of the tile for the scores
// and the columns lane, lane + 32, … of the output (acc is 8 × d/32 a
// thread); the q tile is staged once in shared memory (f32, times scale);
// each kv tile's K (rows padded to an odd float4 stride: conflict-free
// float4 reads across lanes) and V (lane-strided columns) are staged per
// tile, 128.5 KB of shared memory at head_dim 256; row max and row sum are
// warp shuffles, and P·V broadcasts each lane's p with a shuffle.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr float MASKED = -1e30f;

struct Params {
  int hq, hkv, sq, sk, d;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

// The kv tiles [t_lo, t_hi] of width bk that hold a valid key for some row
// of the q tile starting at q0 (all tiles when some row has none).
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

// A score after scale and softcap, then the mask: −inf past the last key,
// MASKED outside the causal/window band.
__device__ __forceinline__ float masked_logit(const Params& p, float s, int qi,
                                              int kj) {
  float x = s;
  if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
  if (kj >= p.sk) return -INFINITY;
  if ((p.causal && qi < kj) || (p.has_window && qi - kj >= p.window))
    return MASKED;
  return x;
}

// ---------------------------------------------------------------------------
// The f32 kernel (CUDA cores).

namespace f32 {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;  // query rows per warp (8)

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

template <int CPL>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, Params p) {
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
  const float* qg = q + (size_t)g * p.sq * p.d;
  const float* kg = k + (size_t)kv * p.sk * p.d;
  const float* vg = v + (size_t)kv * p.sk * p.d;
  float* og = o + (size_t)g * p.sq * p.d;

  // the q tile in f32, times scale (as the TPU kernel scales q), padded
  for (int r = warp; r < BQ; r += WARPS) {
    const int qi = q0 + r;
    for (int c = lane; c < dq; c += 32)
      q_s[r * dq + c] = (qi < p.sq && c < p.d)
          ? qg[(size_t)qi * p.d + c] * p.scale : 0.0f;
  }

  int t_lo, t_hi;
  kv_tiles(p, q0, BQ, BK, t_lo, t_hi);

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
        k_s[r * ks + c] = (in && c < p.d) ? kg[(size_t)kj * p.d + c] : 0.0f;
      for (int c = lane; c < DV; c += 32)
        v_s[r * DV + c] = (in && c < p.d) ? vg[(size_t)kj * p.d + c] : 0.0f;
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
      const float x = masked_logit(p, s[i], qi, kj);
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
    if (lse != nullptr && lane == 0)
      lse[(size_t)g * p.sq + qi] = m[i] + logf(l[i]);
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      if (c < p.d) og[(size_t)qi * p.d + c] = acc[i][t] / den;
    }
  }
}

template <int CPL>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, const Params& p, cudaStream_t stream) {
  const int dq = (p.d + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)BQ * dq +
                                       (size_t)BK * (dq + 4) +
                                       (size_t)BK * 32 * CPL);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.sq + BQ - 1) / BQ, bh);
  flash_kernel<CPL><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, p);
  REPRO_LAUNCH_CHECK();
  return 0;
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, const Params& p, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1: return launch<1>(q, k, v, o, lse, bh, p, stream);
    case 2: return launch<2>(q, k, v, o, lse, bh, p, stream);
    case 3: return launch<3>(q, k, v, o, lse, bh, p, stream);
    case 4: return launch<4>(q, k, v, o, lse, bh, p, stream);
    case 5: return launch<5>(q, k, v, o, lse, bh, p, stream);
    case 6: return launch<6>(q, k, v, o, lse, bh, p, stream);
    case 7: return launch<7>(q, k, v, o, lse, bh, p, stream);
    case 8: return launch<8>(q, k, v, o, lse, bh, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16 inputs).

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;             // queries a block: two warpgroups of 64
constexpr int BK = 64;              // keys a tile
constexpr int WGS = BQ / 64;        // warpgroups a block
constexpr int THREADS = WGS * 128;
static_assert(BQ % 64 == 0 && BK == 64,
              "a warpgroup's S is one m64n64 wgmma accumulator");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes = 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// shared-memory writes of this thread (cp.async, plain stores) become
// visible to the tensor cores' (async proxy) reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A shared-memory matrix descriptor: 128-byte swizzle, 8-row groups 1024
// bytes apart (the stride field of either kind), start at `p` (an 8-row
// group's 1024-byte-aligned base, plus k offsets inside its 128-byte rows)
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define REPRO_D32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define REPRO_D32_STR                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64x64 f32, this warpgroup) (+)= A (64x16, K-major in shared memory) ·
// B (16x64, K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64x64 f32) += A (64x16 bf16 in registers, the m16n8k16 A fragment of
// each warp's 16 rows) · B (16x64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef REPRO_D32
#undef REPRO_D32_STR

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> hi = bf16(x, y), lo = bf16(x − hi, y − hi): x ≈ hi + lo to
// 2^-16 relative.  The lower half holds the lower column.
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// rows [row0, row0 + ROWS) of a (rows, d) bf16 matrix -> a ROWS x D tile in
// the 128-byte swizzled layout: D / 64 column blocks of ROWS x 128 bytes,
// the 16-byte chunk c of row r at chunk c ^ (r % 8); rows at or past
// `limit` and columns at or past d zero.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int limit, int d,
                                          bool vec) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, cc = idx % CH;
    const int row = row0 + r, c = cc * 8;
    bf16* s = dst + (cc >> 3) * ROWS * 64 + r * 64 + (((cc & 7) ^ (r & 7)) << 3);
    if (vec) {
      const bool in = row < limit && c < d;
      cp_async16(s, in ? src + (size_t)row * d + c : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s[e] = (row < limit && c + e < d) ? src[(size_t)row * d + c + e]
                                          : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, Params p, int vec) {
  constexpr int NT = BK / 8;   // score n-tiles (8 keys each)
  constexpr int NB = D / 64;   // output column blocks (64 columns each)
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  bf16* k_s = q_s + BQ * D;       // 2 x BK x D
  bf16* v_s = k_s + 2 * BK * D;   // 2 x BK x D

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;                 // warpgroup: 64 query rows
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int rep = p.hq / p.hkv;
  const int kv = (g / p.hq) * p.hkv + (g % p.hq) / rep;
  const bf16* qg = q + (size_t)g * p.sq * p.d;
  const bf16* kg = k + (size_t)kv * p.sk * p.d;
  const bf16* vg = v + (size_t)kv * p.sk * p.d;
  bf16* og = o + (size_t)g * p.sq * p.d;

  int t_lo, t_hi;
  kv_tiles(p, q0, BQ, BK, t_lo, t_hi);

  load_tile<BQ, D>(q_s, qg, q0, p.sq, p.d, vec);
  cp_async_commit();
  load_tile<BK, D>(k_s, kg, t_lo * BK, p.sk, p.d, vec);
  load_tile<BK, D>(v_s, vg, t_lo * BK, p.sk, p.d, vec);
  cp_async_commit();

  // rows gq and gq + 8 of the warp's 16: running max, partial row sum
  // (this thread's columns; the quad's sum at the end), accumulator
  float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};
  float acc[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[b][e] = 0.0f;

  const bf16* q_w = q_s + wg * 64 * 64;     // this warpgroup's 64 rows
  const int qi0 = q0 + warp * 16 + gq;      // query of row gq (gq + 8: +8)

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int buf = (tile - t_lo) & 1;
    if (tile < t_hi) {  // the next tile loads while this one is computed
      load_tile<BK, D>(k_s + (buf ^ 1) * BK * D, kg, (tile + 1) * BK, p.sk,
                       p.d, vec);
      load_tile<BK, D>(v_s + (buf ^ 1) * BK * D, vg, (tile + 1) * BK, p.sk,
                       p.d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const bf16* k_t = k_s + buf * BK * D;
    const bf16* v_t = v_s + buf * BK * D;

    // S = Q · Kᵀ (64 x BK a warpgroup), f32; s[4n + e] is C fragment
    // element e of the warp's n-th 8-key tile
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk >> 2, kb = (kk & 3) * 16;  // column block, offset
      wgmma_ss(s, desc(q_w + cb * BQ * 64 + kb),
               desc(k_t + cb * BK * 64 + kb), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();

    // scale, softcap, mask; the online softmax on rows gq and gq + 8
    const int k0 = tile * BK;
    float mx[2] = {MASKED, MASKED};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * tq + (e & 1);
        const float x =
            masked_logit(p, s[4 * n + e] * p.scale, qi0 + 8 * (e >> 1), kj);
        s[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(REPRO_FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(REPRO_FULL_MASK, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float pe = expf(s[e] - m[(e >> 1) & 1]);
      s[e] = pe;
      l[(e >> 1) & 1] += pe;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[b][e] *= alpha[(e >> 1) & 1];

    // acc += P_hi · V + P_lo · V, 16 keys at a time; the split P stays in
    // registers until the products that read it are done
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      split(s[8 * kc + 0], s[8 * kc + 1], ph[kc][0], pl[kc][0]);
      split(s[8 * kc + 2], s[8 * kc + 3], ph[kc][1], pl[kc][1]);
      split(s[8 * kc + 4], s[8 * kc + 5], ph[kc][2], pl[kc][2]);
      split(s[8 * kc + 6], s[8 * kc + 7], ph[kc][3], pl[kc][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const uint64_t dv = desc(v_t + b * BK * 64 + kc * 16 * 64);
        wgmma_rs(acc[b], ph[kc], dv);
        wgmma_rs(acc[b], pl[kc], dv);
      }
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // this buffer is loaded again two tiles on
  }

  // o = acc / l in bf16, rows gq and gq + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(REPRO_FULL_MASK, l[i], 1);
    l[i] += __shfl_xor_sync(REPRO_FULL_MASK, l[i], 2);
  }
  const bool pairs = (p.d & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qi0 + 8 * i;
    if (qi >= p.sq) continue;
    if (lse != nullptr && tq == 0)  // m and l are the quad's, after the sum
      lse[(size_t)g * p.sq + qi] = m[i] + logf(l[i]);
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    bf16* orow = og + (size_t)qi * p.d;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = b * 64 + n * 8 + 2 * tq;
        const float x = acc[b][4 * n + 2 * i] * inv;
        const float y = acc[b][4 * n + 2 * i + 1] * inv;
        if (pairs && c + 1 < p.d) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(x, y);
        } else {
          if (c < p.d) orow[c] = __float2bfloat16_rn(x);
          if (c + 1 < p.d) orow[c + 1] = __float2bfloat16_rn(y);
        }
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, const Params& p, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(BQ + 4 * BK) * D + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.sq + BQ - 1) / BQ, bh);
  flash_kernel_tc<D><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, p, vec);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace tc

bool valid(int b, int hq, int hkv, int sk, int d) {
  return d >= 1 && d <= 256 && sk >= 1 && hkv >= 1 && hq % hkv == 0 &&
         (long long)b * hq <= 65535;
}

}  // namespace

// q, o: (b, hq, sq, d); k, v: (b, hkv, sk, d); all contiguous f32;
// 1 <= d <= 256, hq % hkv == 0, sk >= 1, -sk <= window <= sq when
// has_window (the wrapper clamps it); lse: (b, hq, sq) f32, or null for
// none.  The CUDA-core kernel.
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int b, int hq,
                                         int hkv, int sq, int sk, int d,
                                         int causal, int has_window,
                                         int window, int has_softcap,
                                         float softcap, float scale,
                                         void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (!valid(b, hq, hkv, sk, d)) return (int)cudaErrorInvalidValue;
  const Params p{hq, hkv, sq, sk, d, causal, has_window, window, has_softcap,
                 softcap, scale};
  return f32::dispatch(q, k, v, o, (float*)lse, b * hq, p,
                       (cudaStream_t)stream);
}

// The same contract for bf16 q, k, v and o: the tensor-core kernel.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int b,
                                          int hq, int hkv, int sq, int sk,
                                          int d, int causal, int has_window,
                                          int window, int has_softcap,
                                          float softcap, float scale,
                                          void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (!valid(b, hq, hkv, sk, d)) return (int)cudaErrorInvalidValue;
  const Params p{hq, hkv, sq, sk, d, causal, has_window, window, has_softcap,
                 softcap, scale};
  const int vec = d % 8 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int bh = b * hq;
  float* l = (float*)lse;
  if (d <= 64) return tc::launch<64>(q, k, v, o, l, bh, p, vec, st);
  if (d <= 128) return tc::launch<128>(q, k, v, o, l, bh, p, vec, st);
  return tc::launch<256>(q, k, v, o, l, bh, p, vec, st);
}
