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
// path, so the 2·M·N·K adds and ⊕s run on the CUDA cores (67 TFLOP/s f32
// peak).  At the serving shapes (B = 128 rows against a 10,112² f32 weight
// matrix, 409 MB) the operations bound it, not the bytes.
//
// Design:
//  * a block owns a 64 x 128 output tile; each thread owns 8 rows x 4
//    columns (32 accumulators in registers);
//  * per 32-deep K stage, the A tile (64 x 32) and the B tile (32 x 128)
//    are staged in shared memory; B is read as one float4 per thread per k,
//    A as broadcast float4s (four k of one row);
//  * a K stage whose A tile is all ⊕-zero (converged or masked frontier
//    rows) skips its B load and its compute (__syncthreads_or);
//  * out-of-range loads read the ⊕-zero, so ragged M, K and N need no host
//    padding.  Each candidate is the same IEEE f32 add as the plain
//    version's, and min / max do not depend on order, so the result is
//    bit-identical to it.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;              // 32 column groups x 8 row groups
constexpr int RPT = BM / (THREADS / 32);  // rows per thread (8)
constexpr int CPT = BN / 32;              // columns per thread (4)

struct MinOp {
  static __device__ __forceinline__ float zero() { return INFINITY; }
  static __device__ __forceinline__ float reduce(float a, float b) { return fminf(a, b); }
};

struct MaxOp {
  static __device__ __forceinline__ float zero() { return -INFINITY; }
  static __device__ __forceinline__ float reduce(float a, float b) { return fmaxf(a, b); }
};

template <class Op>
__global__ void __launch_bounds__(THREADS)
tropical_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float a_s[BM][BK];   // 8 KB
  __shared__ __align__(16) float b_s[BK][BN];   // 16 KB

  const int tid = threadIdx.x;
  const int cg = tid & 31;  // column group: columns 4*cg .. 4*cg+3
  const int rg = tid >> 5;  // row group: rows 8*rg .. 8*rg+7
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = Op::zero();

  for (int k0 = 0; k0 < K; k0 += BK) {
    int live = 0;
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      const float v = (gr < M && gk < K) ? a[(size_t)gr * K + gk] : Op::zero();
      a_s[r][kk] = v;
      live |= (v != Op::zero());
    }
    if (!__syncthreads_or(live)) continue;  // the whole A tile is ⊕-zero

    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = col0 + c;
      b_s[kk][c] = (gk < K && gc < N) ? b[(size_t)gk * N + gc] : Op::zero();
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        bv[u] = *reinterpret_cast<const float4*>(&b_s[kk + u][CPT * cg]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(&a_s[rg * RPT + r][kk]);
        const float as[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[r][0] = Op::reduce(acc[r][0], __fadd_rn(as[u], bv[u].x));
          acc[r][1] = Op::reduce(acc[r][1], __fadd_rn(as[u], bv[u].y));
          acc[r][2] = Op::reduce(acc[r][2], __fadd_rn(as[u], bv[u].z));
          acc[r][3] = Op::reduce(acc[r][3], __fadd_rn(as[u], bv[u].w));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + rg * RPT + r;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = col0 + CPT * cg + c;
      if (col < N) out[(size_t)row * N + col] = acc[r][c];
    }
  }
}

template <class Op>
int tropical_matmul(const void* a, const void* b, void* out, int M, int K,
                    int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tropical_matmul_kernel<Op><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, M, K, N);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

// a: (M, K) f32, b: (K, N) f32, out: (M, N) f32 — all contiguous.
extern "C" int repro_minplus_matmul(const void* a, const void* b, void* out,
                                    int M, int K, int N, void* stream) {
  return tropical_matmul<MinOp>(a, b, out, M, K, N, stream);
}

extern "C" int repro_maxplus_matmul(const void* a, const void* b, void* out,
                                    int M, int K, int N, void* stream) {
  return tropical_matmul<MaxOp>(a, b, out, M, K, N, stream);
}
