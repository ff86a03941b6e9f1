// K1 — boolean (∨,∧) frontier product: out[m, n] = OR_k a[m, k] & b[k, n].
//
// Replaces: src/repro/kernels/boolmm.py, `bool_matmul` / `_boolmm_kernel`
// (serving entry `bool_frontier_matmul`), the TPU kernel that runs the
// product as an f32 MXU matmul with a `> 0` epilogue over (8, 128) padded
// tiles.
//
// What bounds it on the H100: at the serving shapes (B = 128 frontier rows
// against a 10,112-vertex adjacency) the adjacency is 102 MB of 0/1 bytes,
// read once per iteration (two block-rows read it twice), so device memory
// bounds the ideal; the byte-wise OR work is 2·B·n² operations, far below
// the int8 peak.  This kernel does that work on the CUDA cores whatever the
// data (only all-zero frontier tiles are skipped), so it runs well above
// the byte bound; PERF.md has both.
//
// Design:
//  * operands stay 0/1 bytes (torch.bool); no f32 copy of the adjacency;
//  * a block owns a 64 x 128 output tile; each thread owns 8 rows x 4
//    columns, the 4 columns packed as the 4 bytes of one 32-bit word, so a
//    single AND/OR updates four outputs (the result is exact, hence
//    bit-identical to the TPU kernel and to the plain version);
//  * the A tile is staged in shared memory as 0 / 0xFFFFFFFF masks and read
//    four k at a time with one broadcast 128-bit load per row;
//  * a K stage whose A tile is all zero (converged or masked frontier rows)
//    skips its B load and its compute (__syncthreads_or);
//  * ragged M, K and N are masked in the loads and stores — nothing is
//    padded to 8 or 128 on the host.
#include "common.cuh"

namespace {

constexpr int BM = 64;                  // output rows per block
constexpr int BN = 128;                 // output columns per block
constexpr int BK = 32;                  // K depth per shared-memory stage
constexpr int THREADS = 256;            // 32 column words x 8 row groups
constexpr int RPT = BM / (THREADS / 32);  // rows per thread (8)

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
bool_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                   uint8_t* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) uint32_t a_mask[BM][BK];   // 0 or ~0u per (m, k)
  __shared__ __align__(16) uint32_t b_tile[BK][BN / 4];  // 4 columns a word
  uint8_t* b_bytes = reinterpret_cast<uint8_t*>(&b_tile[0][0]);

  const int tid = threadIdx.x;
  const int cw = tid & 31;   // column word of this thread
  const int rg = tid >> 5;   // row group (one warp per group)
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  uint32_t acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    int any = 0;
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;  // k fastest: coalesced row reads
      const int gr = row0 + r, gk = k0 + kk;
      const uint32_t v =
          (gr < M && gk < K) ? (uint32_t)(a[(size_t)gr * K + gk] != 0) : 0u;
      a_mask[r][kk] = 0u - v;
      any |= (int)v;
    }
    if (!__syncthreads_or(any)) continue;  // the whole A tile is empty

    if (VEC) {  // N % 4 == 0 and b is 4-byte aligned: one word per load
      for (int i = tid; i < BK * (BN / 4); i += THREADS) {
        const int kk = i / (BN / 4), w = i % (BN / 4);
        const int gk = k0 + kk, gc = col0 + 4 * w;
        b_tile[kk][w] = (gk < K && gc < N)
            ? *reinterpret_cast<const uint32_t*>(b + (size_t)gk * N + gc)
            : 0u;
      }
    } else {
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, c = i % BN;
        const int gk = k0 + kk, gc = col0 + c;
        b_bytes[kk * BN + c] =
            (gk < K && gc < N) ? (uint8_t)(b[(size_t)gk * N + gc] != 0) : 0;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      const uint32_t b0 = b_tile[kk][cw], b1 = b_tile[kk + 1][cw];
      const uint32_t b2 = b_tile[kk + 2][cw], b3 = b_tile[kk + 3][cw];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const uint4 m = *reinterpret_cast<const uint4*>(&a_mask[rg * RPT + r][kk]);
        acc[r] |= (b0 & m.x) | (b1 & m.y) | (b2 & m.z) | (b3 & m.w);
      }
    }
    __syncthreads();
  }

  const int col = col0 + 4 * cw;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + rg * RPT + r;
    if (row >= M || col >= N) continue;
    uint8_t* dst = out + (size_t)row * N + col;
    if (VEC) {
      *reinterpret_cast<uint32_t*>(dst) = acc[r];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < N) dst[j] = (uint8_t)((acc[r] >> (8 * j)) & 0xffu);
    }
  }
}

}  // namespace

// a: (M, K) bool, b: (K, N) bool, out: (M, N) bool — all contiguous.
extern "C" int repro_bool_matmul(const void* a, const void* b, void* out,
                                 int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (N % 4 == 0) && ((uintptr_t)b % 4 == 0) &&
                   ((uintptr_t)out % 4 == 0);
  const uint8_t* pa = (const uint8_t*)a;
  const uint8_t* pb = (const uint8_t*)b;
  uint8_t* po = (uint8_t*)out;
  if (vec)
    bool_matmul_kernel<true><<<grid, THREADS, 0, s>>>(pa, pb, po, M, K, N);
  else
    bool_matmul_kernel<false><<<grid, THREADS, 0, s>>>(pa, pb, po, M, K, N);
  REPRO_LAUNCH_CHECK();
  return 0;
}
