// K8 — the fused semi-naive relaxation step on the CUDA cores:
//
//   U       = Δ-masked d ⊗_min,+ a    (row m of d is +inf unless delta[m])
//   dnew    = min(d, U)                (the merge into `all`)
//   changed = any(dnew < d), per row   (the next Δ)
//
// Replaces: src/repro/kernels/relax.py, `relax_step` / `_relax_kernel`, the
// TPU kernel that accumulates the candidate tile in VMEM over a sequential
// (M/bm, N/bn, K/bk) grid and applies the merge and the per-row flags in
// its epilogue.  One call is one iteration of the PreM-optimised
// shortest-path program, in one pass over device memory instead of three.
//
// What bounds it on the H100: like K2, no tropical product has a
// tensor-core path, so the 2·n³ adds and mins (fewer where Δ rows or whole
// A tiles are +inf) run on the CUDA cores, 67 TFLOP/s f32 peak.  At the
// all-pairs shapes (n = 10,000: d, a and dnew are 400 MB each) the
// operations bound it, not the bytes, by two orders of magnitude.
//
// Design (K2's structure, with the mask and the merge fused in):
//  * a block owns a 64 x 128 output tile; each thread owns 8 rows x 4
//    columns (32 accumulators in registers); 32-deep K stages of the A
//    tile (64 x 32 rows of d) and the B tile (32 x 128 of a) are staged in
//    shared memory;
//  * the Δ mask is applied at load: row m of d enters the A tile as +inf
//    when delta[m] is false, so no masked (n, n) copy is ever built (400 MB
//    a step at n = 10,000).  Each thread reads the mask of its 8 A-tile
//    rows once, into a bitmask in one register, and its fully unrolled
//    loads test a bit (a first version read a shared-memory row mask in a
//    rolled load loop, with the K loop inside a branch, and took about 1.4
//    times K2's time on the same step; PERF.md).  A row tile whose Δ rows
//    are all false runs no K loop: its epilogue copies the dcur tile to
//    dnew and raises no flag;
//  * a K stage whose A tile is all +inf skips its B load and its compute
//    (__syncthreads_or), as in K2;
//  * the epilogue runs while the tile is in registers: it reads the dcur
//    tile, writes min(dcur, acc) and raises the row's flag where
//    merged < dcur (strict, as the TPU kernel and the plain version write
//    it);
//  * out-of-range loads read +inf and out-of-range stores are dropped, so
//    ragged n needs no padding (the TPU kernel asserts n divides the
//    blocks).  Each candidate is the same IEEE f32 add as the plain
//    version's, and min does not depend on order, so the result is
//    bit-identical to it.
//
// Two places where the TPU kernel does not carry over:
//  * The changed flags cross column tiles.  The TPU kernel writes a row
//    tile's flags at column step j == 0 and ORs them in for j != 0, which
//    relies on its grid running in order.  Here the blocks of one row tile
//    run in any order and at the same time.  So the wrapper zeroes the (n,)
//    flag buffer before the launch, a block only ever stores a 1 (never a
//    0, so concurrent stores cannot lose one), and the wrapper views the
//    buffer as torch.bool.  One lane per warp stores, after a warp vote over
//    the warp's 128 columns of that row.
//  * d is both the left operand and dcur.  Other blocks' K stages read rows
//    of d while this block writes its output tile, so dnew must never alias
//    d: the wrapper allocates dnew afresh, and a caller's loop swaps
//    buffers (d, mask = relax(d, a, mask)).
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;              // 32 column groups x 8 row groups
constexpr int RPT = BM / (THREADS / 32);  // rows per thread (8)
constexpr int CPT = BN / 32;              // columns per thread (4)
constexpr int LOADS = BM * BK / THREADS;  // A-tile loads per thread (8)

__global__ void __launch_bounds__(THREADS)
relax_kernel(const float* __restrict__ d, const float* __restrict__ a,
             const uint8_t* __restrict__ delta, float* __restrict__ dnew,
             uint8_t* __restrict__ changed, int n) {
  __shared__ __align__(16) float a_s[BM][BK];   // 8 KB
  __shared__ __align__(16) float b_s[BK][BN];   // 16 KB

  const int tid = threadIdx.x;
  const int cg = tid & 31;  // column group: columns 4*cg .. 4*cg+3
  const int rg = tid >> 5;  // row group (one warp): rows 8*rg .. 8*rg+7
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = INFINITY;

  // Load j of the A tile gives this thread row (tid + j*THREADS) / BK of
  // the tile; bit j of in_delta says whether that row is in Δ.
  unsigned in_delta = 0;
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int gr = row0 + (tid + j * THREADS) / BK;
    if (gr < n && delta[gr]) in_delta |= 1u << j;
  }
  // a row tile with no Δ row runs no K loop
  const int k_end = __syncthreads_or(in_delta != 0) ? n : 0;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    int live = 0;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / BK, kk = i % BK;
      const int gk = k0 + kk;
      const float v = ((in_delta >> j) & 1u) && gk < n
                          ? d[(size_t)(row0 + r) * n + gk] : INFINITY;
      a_s[r][kk] = v;
      live |= (v != INFINITY);
    }
    if (!__syncthreads_or(live)) continue;  // the whole A tile is +inf

    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = col0 + c;
      b_s[kk][c] = (gk < n && gc < n) ? a[(size_t)gk * n + gc] : INFINITY;
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
        const float4 av =
            *reinterpret_cast<const float4*>(&a_s[rg * RPT + r][kk]);
        const float as[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[r][0] = fminf(acc[r][0], __fadd_rn(as[u], bv[u].x));
          acc[r][1] = fminf(acc[r][1], __fadd_rn(as[u], bv[u].y));
          acc[r][2] = fminf(acc[r][2], __fadd_rn(as[u], bv[u].z));
          acc[r][3] = fminf(acc[r][3], __fadd_rn(as[u], bv[u].w));
        }
      }
    }
    __syncthreads();
  }

  // epilogue: merge with the dcur tile and raise the per-row flags
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + rg * RPT + r;  // the same for the whole warp
    int improved = 0;
    if (row < n) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = col0 + CPT * cg + c;
        if (col < n) {
          const size_t at = (size_t)row * n + col;
          const float cur = d[at];
          const float merged = fminf(cur, acc[r][c]);
          dnew[at] = merged;
          improved |= (merged < cur);
        }
      }
    }
    if (__any_sync(REPRO_FULL_MASK, improved) && cg == 0) changed[row] = 1;
  }
}

}  // namespace

// d, a, dnew: (n, n) f32; delta: (n,) bool bytes; changed: (n,) bytes,
// zeroed by the caller — all contiguous; dnew must not alias d.
extern "C" int repro_relax_step(const void* d, const void* a,
                                const void* delta, void* dnew, void* changed,
                                int n, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + BN - 1) / BN, (n + BM - 1) / BM);
  relax_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)a, (const uint8_t*)delta, (float*)dnew,
      (uint8_t*)changed, n);
  REPRO_LAUNCH_CHECK();
  return 0;
}
