// K2 — tropical frontier products on the CUDA cores, one template for both
// idempotent weighted carriers:
//
//   min-plus: out[m, n] = min_k a[m, k] + b[k, n]   (⊕-zero +inf)
//   max-plus: out[m, n] = max_k a[m, k] + b[k, n]   (⊕-zero -inf)
//
// Replaces: src/repro/kernels/minplus.py, `minplus_matmul` /
// `_minplus_kernel` (serving entry `minplus_frontier_matmul`), the TPU
// kernel that runs a blocked broadcast-add + min-reduce on the VPU with
// (8, 128, 32) blocks and +inf padding.  The JAX package serves max-plus
// through the same kernel by negation (`ops.maxplus_frontier`:
// -minplus(-a, -b)); here the ⊕ is a template parameter instead, so the
// host loop never negates the (n, n) arc matrix.  (-a) + (-b) = -(a + b)
// exactly in IEEE f32, so the max instantiation is bit-identical to the
// negation route.
//
// What bounds it on the H100: neither tropical product has a tensor-core
// path, so each candidate costs an FADD and an FMNMX on the CUDA cores
// (16.7 T candidates/s at 67 T ops/s).  Only live candidates count: a
// ⊕-zero a[m, k] makes all of row m's candidates at k ⊕-zero.  At the
// serving shape (B = 128 rows against a 10,112² f32 weight matrix) the 409
// MB of B set the floor (0.125 ms) when few a[m, k] are live; at M = n on
// the G10K arcs (0.1% live) the bytes too, B being read once per 128-row
// tile; where a warp's rows are dense the candidates do.
//
// Design:
//  * a block of 16 warps owns a 128 x 128 output tile (so at B <= 128 the
//    weight matrix is read once); a warp owns 8 rows, a lane 4 columns: an
//    8 x 4 register tile, 32 accumulators;
//  * the grid is filled by splitting K: blockIdx.z takes one k range of the
//    plan the wrapper computes (`minplus.plan`); with more than one split,
//    each block writes its ⊕-partial tile to a scratch (splits, M, N) and a
//    second kernel ⊕-combines the splits.  min and max are exact and do not
//    depend on order, so the result keeps its bits;
//  * 32-deep stages of A (128 x 32) and B (32 x 128) go through a ring of 3
//    stages in shared memory (96 KB) by 16-byte `cp.async`, two stages in
//    flight while one is computed;
//  * the dead-entry skip: when a stage has landed, each warp takes a ballot
//    per row of its 8 (bit k: a[m, k] is live).  With few live pairs in the
//    stage (at most WALK_MAX of 256) each row walks its own live k, a loop
//    over the ballot's bits (warp-uniform), so a dead (row, k) pair costs
//    no add and no ⊕ and time falls with the live share; with more, the
//    warp runs the register-blocked 8 x 4 update over the stage, each B
//    value read once for 8 rows;
//  * out-of-range entries (rows >= M, k past the split, columns >= N) are
//    staged as the ⊕-zero, so ragged shapes need no host padding.  When K
//    or N is not a multiple of 4, or a pointer is not 16-byte aligned, the
//    stages load with predicated scalar loads instead (the plan's
//    unaligned route), into the same layout.
//
// Signed zeros: each candidate is one __fadd_rn, as in the plain version,
// and min / max differ from the plain version only where +0 and -0 tie.
// No -0 reaches this kernel on the served paths: the weights are an
// integer EDB column cast to f32 (+0 at worst), the frontiers are sums of
// them and the vertex labels of CC (x + y is -0 only when both are -0), and
// the ⊕-zeros are ±inf; so no candidate is -0 and the split order cannot
// change a bit.
//
// Registers: `-Xptxas -v` (chip_smoke.py's build phase) reports 125 on the
// aligned route and 88 on the predicated one, no spill; the combine 32.
#include "common.cuh"

namespace {

constexpr int BM = 128;                  // output rows a block
constexpr int BN = 128;                  // output columns a block
constexpr int BK = 32;                   // k a stage: one ballot bit a lane
constexpr int STAGES = 3;                // cp.async ring depth
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BM / WARPS;          // rows a warp (8)
constexpr int CPT = BN / 32;             // columns a lane (4)
constexpr int SMEM = STAGES * (BM * BK + BK * BN) * (int)sizeof(float);
// a warp walks its rows' live k when a stage holds at most this many live
// (row, k) pairs of its 8 x 32, else it runs the register-blocked update:
// a walked pair reads 512 bytes of B from shared memory, the blocked
// update 2 KB a group of 4 k for all 8 rows
constexpr int WALK_MAX = 80;

struct MinOp {
  static __device__ __forceinline__ float zero() { return INFINITY; }
  static __device__ __forceinline__ float reduce(float a, float b) { return fminf(a, b); }
};

struct MaxOp {
  static __device__ __forceinline__ float zero() { return -INFINITY; }
  static __device__ __forceinline__ float reduce(float a, float b) { return fmaxf(a, b); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage: a[m0 .. m0+BM, k0 .. k0+BK) into a_s (row-major, BK a row) and
// b[k0 .. k0+BK, n0 .. n0+BN) into b_s (row-major, BN a row); rows >= M,
// k >= k_hi and columns >= N are the ⊕-zero.
template <class Op, bool VEC>
__device__ __forceinline__ void load_stage(float* a_s, float* b_s,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int M, int K, int N, int m0,
                                           int n0, int k0, int k_hi) {
  const float z = Op::zero();
  const float4 z4 = make_float4(z, z, z, z);
  for (int i = threadIdx.x; i < BM * (BK / 4); i += THREADS) {
    const int r = i / (BK / 4), c = i % (BK / 4);
    const int gm = m0 + r, gk = k0 + 4 * c;
    float* dst = a_s + r * BK + 4 * c;
    if (VEC) {  // K % 4 == 0 and k_hi % 4 == 0: a chunk is in or out whole
      if (gm < M && gk < k_hi)
        cp_async16(dst, a + (size_t)gm * K + gk);
      else
        *reinterpret_cast<float4*>(dst) = z4;
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (gm < M && gk + e < k_hi) ? a[(size_t)gm * K + gk + e] : z;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  for (int i = threadIdx.x; i < BK * (BN / 4); i += THREADS) {
    const int r = i / (BN / 4), c = i % (BN / 4);
    const int gk = k0 + r, gn = n0 + 4 * c;
    float* dst = b_s + r * BN + 4 * c;
    if (VEC) {  // N % 4 == 0
      if (gk < k_hi && gn < N)
        cp_async16(dst, b + (size_t)gk * N + gn);
      else
        *reinterpret_cast<float4*>(dst) = z4;
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (gk < k_hi && gn + e < N) ? b[(size_t)gk * N + gn + e] : z;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <class Op>
__device__ __forceinline__ void update(float (&acc)[CPT], float av,
                                       const float4& bv) {
  acc[0] = Op::reduce(acc[0], __fadd_rn(av, bv.x));
  acc[1] = Op::reduce(acc[1], __fadd_rn(av, bv.y));
  acc[2] = Op::reduce(acc[2], __fadd_rn(av, bv.z));
  acc[3] = Op::reduce(acc[3], __fadd_rn(av, bv.w));
}

// dst (M, N) row-major: out itself with one split, else the split's slice
// of the scratch.
template <class Op, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
tropical_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, float* __restrict__ scratch, int M,
                int K, int N, int k_chunk) {
  extern __shared__ __align__(16) float smem[];
  float* a_ring = smem;                         // STAGES x BM x BK
  float* b_ring = smem + STAGES * BM * BK;      // STAGES x BK x BN

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(K, k_lo + k_chunk);
  const int nst = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  float acc[RPW][CPT];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = Op::zero();

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst)
      load_stage<Op, VEC>(a_ring + s * BM * BK, b_ring + s * BK * BN, a, b, M,
                          K, N, m0, n0, k_lo + s * BK, k_hi);
    cp_async_commit();
  }

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage s landed
    __syncthreads();              // everyone's; and stage s - 1 is consumed
    {
      const int t = s + STAGES - 1, slot = t % STAGES;
      if (t < nst)
        load_stage<Op, VEC>(a_ring + slot * BM * BK, b_ring + slot * BK * BN,
                            a, b, M, K, N, m0, n0, k_lo + t * BK, k_hi);
      cp_async_commit();
    }
    const float* a_t = a_ring + (s % STAGES) * BM * BK + warp * RPW * BK;
    const float* b_t = b_ring + (s % STAGES) * BK * BN + CPT * lane;

    // bit k of live[r]: a[row r of this warp, k] is not the ⊕-zero
    uint32_t live[RPW];
    int count = 0;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      live[r] = __ballot_sync(REPRO_FULL_MASK, a_t[r * BK + lane] != Op::zero());
      count += __popc(live[r]);
    }
    if (count == 0) continue;  // no live row in this stage

    if (count > WALK_MAX) {
      // many live pairs: the register-blocked update over the whole stage,
      // each B value read once for the 8 rows (a dead a is the ⊕-zero, so
      // its candidates drop out)
#pragma unroll
      for (int q = 0; q < BK / 4; ++q) {
        float4 bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          bv[u] = *reinterpret_cast<const float4*>(b_t + (4 * q + u) * BN);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(a_t + r * BK + 4 * q);
          update<Op>(acc[r], av.x, bv[0]);
          update<Op>(acc[r], av.y, bv[1]);
          update<Op>(acc[r], av.z, bv[2]);
          update<Op>(acc[r], av.w, bv[3]);
        }
      }
      continue;
    }
    // few: each row walks its own live k, two at a time (a lone last k is
    // taken twice: ⊕ is idempotent); the loop runs on the ballot's bits, so
    // it is warp-uniform, and a dead pair costs nothing
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      uint32_t bits = live[r];
      while (bits != 0u) {
        const int k0 = __ffs(bits) - 1;
        bits &= bits - 1u;
        const int k1 = bits != 0u ? __ffs(bits) - 1 : k0;
        bits &= bits - 1u;
        const float4 b0 = *reinterpret_cast<const float4*>(b_t + k0 * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(b_t + k1 * BN);
        const float a0 = a_t[r * BK + k0], a1 = a_t[r * BK + k1];
        update<Op>(acc[r], a0, b0);
        update<Op>(acc[r], a1, b1);
      }
    }
  }
  cp_async_wait<0>();

  float* dst = gridDim.z > 1 ? scratch + (size_t)blockIdx.z * M * N : out;
  const int col = n0 + CPT * lane;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = m0 + warp * RPW + r;
    if (row >= M || col >= N) continue;
    float* p = dst + (size_t)row * N + col;
    if (VEC) {  // N % 4 == 0: the 4 columns are in or out together
      *reinterpret_cast<float4*>(p) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (col + c < N) p[c] = acc[r][c];
    }
  }
}

// out[i] = ⊕ over the splits of scratch[s, i]
template <class Op>
__global__ void combine_kernel(const float* __restrict__ scratch,
                               float* __restrict__ out, int splits,
                               size_t mn) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += stride) {
    float v = scratch[i];
    for (int s = 1; s < splits; ++s) v = Op::reduce(v, scratch[s * mn + i]);
    out[i] = v;
  }
}

template <class Op, bool VEC>
int launch(const float* a, const float* b, float* out, float* scratch, int M,
           int K, int N, int k_chunk, int splits, cudaStream_t s) {
  static bool attr = false;  // once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        tropical_kernel<Op, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  tropical_kernel<Op, VEC><<<grid, THREADS, SMEM, s>>>(a, b, out, scratch, M,
                                                       K, N, k_chunk);
  REPRO_LAUNCH_CHECK();
  if (splits > 1) {
    const size_t mn = (size_t)M * N;
    const size_t want = (mn + 255) / 256, cap = (size_t)132 * 16;
    const int blocks = (int)(want < cap ? want : cap);
    combine_kernel<Op><<<blocks, 256, 0, s>>>(scratch, out, splits, mn);
    REPRO_LAUNCH_CHECK();
  }
  return 0;
}

template <class Op>
int tropical_matmul(const void* a, const void* b, void* out, void* scratch,
                    int M, int K, int N, int k_chunk, int splits, int vec,
                    void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  float* po = (float*)out;
  float* ps = (float*)scratch;
  return vec ? launch<Op, true>(pa, pb, po, ps, M, K, N, k_chunk, splits, s)
             : launch<Op, false>(pa, pb, po, ps, M, K, N, k_chunk, splits, s);
}

}  // namespace

// a: (M, K) f32, b: (K, N) f32, out: (M, N) f32 — all contiguous; scratch:
// (splits, M, N) f32 when splits > 1.  k_chunk, splits and vec come from
// the wrapper's plan (kernels/minplus.py).
extern "C" int repro_minplus_matmul(const void* a, const void* b, void* out,
                                    void* scratch, int M, int K, int N,
                                    int k_chunk, int splits, int vec,
                                    void* stream) {
  return tropical_matmul<MinOp>(a, b, out, scratch, M, K, N, k_chunk, splits,
                                vec, stream);
}

extern "C" int repro_maxplus_matmul(const void* a, const void* b, void* out,
                                    void* scratch, int M, int K, int N,
                                    int k_chunk, int splits, int vec,
                                    void* stream) {
  return tropical_matmul<MaxOp>(a, b, out, scratch, M, K, N, k_chunk, splits,
                                vec, stream);
}
