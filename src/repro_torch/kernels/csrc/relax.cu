// K8 — the fused semi-naive relaxation step:
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
// Two routes, chosen by the wrapper (kernels/relax.py) from a's density:
//
// The arc-list route (sparse a: the all-pairs paths' arc matrices).
//  What bounds it: device memory.  Its useful work is |Δ|·|E| candidates
//  (an add and a min each): at G10K (n = 10,000, |E| = 100,292) at most
//  1.0e9, 0.03 ms at the f32 rate, while reading d and a and writing dnew
//  moves 1.2 GB, 0.36 ms at 3.35 TB/s.  The dense product computes all
//  2·n³ = 2e12 candidates, a thousand times the useful ones.
//  Design:
//   * pre-pass: a's column lists, its live (not +inf) entries by column,
//     built on the card each call (nothing is cached, so an in-place write
//     to a is always seen).  relax_csc_count_kernel reads a once
//     (streaming, eight loads in flight a thread) into a one-bit-an-entry
//     mask (n²/8 bytes, 12.5 MB at n = 10,000: it stays in L2; a column
//     group's words for eight rows are one 32-byte run) and each
//     (256-row chunk, column)'s count; relax_csc_colscan_kernel and
//     relax_csc_gscan_kernel turn the counts into offsets and also list
//     the Δ rows; the wrapper reads the totals (its one sync: the lists'
//     length, and the density that picks the route);
//     relax_csc_fill_kernel reads only the mask and the live entries;
//   * the lists' layout: columns go in groups of 32, and a group's entries
//     form an (L, 32) block (L its longest column, shorter ones padded
//     with (k = 0, w = +inf), which never lowers a minimum), so the 32
//     lanes of a warp, one column each, read their t-th entries in one
//     coalesced load; a lane past its own column's entries loads and
//     gathers nothing, so the pads cost neither L2 traffic nor shared
//     memory cycles.  The whole of it, about 1.4 MB at G10K, stays in L2;
//   * main pass (relax_arcs_kernel<R>): a block owns R Δ rows (R = 4 up to
//     n = 14,528, else 2 or 1: R rows of d must fit 227 KB of shared
//     memory) and stages them interleaved (one 16-byte load gives the 4
//     rows' d[·, k]); each warp walks one column group at a time, each
//     lane gathering d[m, k] for its R rows from shared memory, four list
//     entries in flight.  With few Δ rows the column groups are split over
//     the grid too, so that the card stays full;
//   * the epilogue merges with d[m, j] (already staged) and raises the
//     row's flag where the merged value is lower, as the tiled route does;
//   * rows outside Δ are copied d -> dnew by relax_copy_rows_kernel (one
//     block a row; Δ rows exit at once) and raise no flag.

// The tiled route (dense a).
//  What bounds it: like K2, no tropical product has a tensor-core path, so
//  the 2·n³ adds and mins (fewer where Δ rows or whole A tiles are +inf)
//  run on the CUDA cores, 67 TFLOP/s f32 peak; the operations bound it.
//  Design (K2's first structure, with the mask and the merge fused in):
//   * a block owns a 64 x 128 output tile; each thread owns 8 rows x 4
//     columns (32 accumulators in registers); 32-deep K stages of the A
//     tile (64 x 32 rows of d) and the B tile (32 x 128 of a) are staged in
//     shared memory;
//   * the Δ mask is applied at load: row m of d enters the A tile as +inf
//     when delta[m] is false, so no masked (n, n) copy is ever built (400 MB
//     a step at n = 10,000).  Each thread reads the mask of its 8 A-tile
//     rows once, into a bitmask in one register, and its fully unrolled
//     loads test a bit.  A row tile whose Δ rows are all false runs no K
//     loop: its epilogue copies the dcur tile to dnew and raises no flag;
//   * a K stage whose A tile is all +inf skips its B load and its compute
//     (__syncthreads_or), as in K2;
//   * the epilogue runs while the tile is in registers: it reads the dcur
//     tile, writes min(dcur, acc) and raises the row's flag where
//     merged < dcur (strict, as the TPU kernel and the plain version write
//     it);
//   * out-of-range loads read +inf and out-of-range stores are dropped, so
//     ragged n needs no padding (the TPU kernel asserts n divides the
//     blocks).
//
// The crossover: at the first step of an n = 10,000 loop (d = a, every
// row in Δ) the arc-list route takes 1.4 ms at 0.1% live and grows with
// the live entries (40 ms at 10%, 115 ms at 30%), while the tiled route
// takes 95-109 ms at any density; they cross at 28% live on an H100
// (chip_smoke.k8_density_sweep), which kernels/relax.py's ARC_DENSITY
// records.
//
// Both routes compute each candidate as the same IEEE f32 add as the plain
// version and take min, which does not depend on order, so each is
// bit-identical to it (no -0 reaches K8 on its paths: a tie of -0 and +0
// could differ in the sign of the zero).
//
// Two places where the TPU kernel does not carry over:
//  * The changed flags cross blocks.  The TPU kernel writes a row tile's
//    flags at column step j == 0 and ORs them in for j != 0, which relies
//    on its grid running in order.  Here the blocks of one row run in any
//    order and at the same time.  So the wrapper zeroes the (n,) flag
//    buffer before the launch, a block only ever stores a 1 (never a 0, so
//    concurrent stores cannot lose one), and the wrapper views the buffer
//    as torch.bool.
//  * d is both the left operand and dcur.  Other blocks read rows of d
//    while this block writes its output, so dnew must never alias d: the
//    wrapper allocates dnew afresh, and a caller's loop swaps buffers
//    (d, mask = relax(d, a, mask)).
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
relax_tiled_kernel(const float* __restrict__ d, const float* __restrict__ a,
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

// ---------------------------------------------------------------------------
// The arc-list route.

constexpr int CSC_COLS = 256;     // columns a count / fill block, one a thread
constexpr int CSC_ROWS = 256;     // rows a count / fill block walks
constexpr int CSC_BATCH = 8;      // rows a batch (loads in flight a thread)
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_GROUPS = (58112 + 31) / 32;  // column groups at n <= 58,112
constexpr int ARC_THREADS = 1024;
constexpr int ARC_UNROLL = 8;     // list entries in flight a thread
constexpr int STAGE_UNROLL = 4;   // d loads in flight a thread, times R
constexpr int COPY_THREADS = 256;

// bits[j / 32][k] bit j % 32: a[k, j] is live (not +inf), a row of kpad
// (n rounded up to 8) words a column group; cnt[c][j]: the live entries of
// column j in rows c·CSC_ROWS .. (c+1)·CSC_ROWS.
__global__ void __launch_bounds__(CSC_COLS)
relax_csc_count_kernel(const float* __restrict__ a, int n, int kpad,
                       unsigned* __restrict__ bits, int* __restrict__ cnt) {
  const int j = blockIdx.x * CSC_COLS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool word_ok = j - lane < n;  // the warp's first column
  const int k0 = blockIdx.y * CSC_ROWS, k1 = min(n, k0 + CSC_ROWS);
  unsigned* out = bits + (size_t)(j >> 5) * kpad;
  int c = 0;
  for (int kb = k0; kb < k1; kb += CSC_BATCH) {  // uniform: ballots whole
    float v[CSC_BATCH];
#pragma unroll
    for (int u = 0; u < CSC_BATCH; ++u)
      v[u] = j < n && kb + u < k1 ? __ldcs(a + (size_t)(kb + u) * n + j)
                                  : INFINITY;
    unsigned m[CSC_BATCH];
#pragma unroll
    for (int u = 0; u < CSC_BATCH; ++u) {
      const bool live = v[u] != INFINITY;
      m[u] = __ballot_sync(REPRO_FULL_MASK, live);
      c += live;
    }
    if (lane == 0 && word_ok) {  // kb % 8 == 0 and kb + 8 <= kpad
      uint4* o = reinterpret_cast<uint4*>(out + kb);
      o[0] = make_uint4(m[0], m[1], m[2], m[3]);
      o[1] = make_uint4(m[4], m[5], m[6], m[7]);
    }
  }
  if (j < n) cnt[(size_t)blockIdx.y * n + j] = c;
}

// An exclusive scan of one value a thread over the block (blockDim.x a
// multiple of 32, at most 1024); *total gets the sum.  Every thread calls.
template <class T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sum[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(REPRO_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T s = lane < nw ? warp_sum[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(REPRO_FULL_MASK, s, o);
      if (lane >= o) s += y;
    }
    warp_sum[lane] = s;
  }
  __syncthreads();
  const T out = (wid ? warp_sum[wid - 1] : T(0)) + x - v;
  *total = warp_sum[nw - 1];
  __syncthreads();  // warp_sum is reused by the next call
  return out;
}

// Per column j (1024 a block): off[c][j], the live entries of column j in
// the chunks before c, and ccnt[j], all of them; per group of 32 columns,
// glen[g], the longest of its 32 columns; per block, its live entries in
// part[blockIdx.x].
__global__ void __launch_bounds__(SCAN_THREADS)
relax_csc_colscan_kernel(const int* __restrict__ cnt, int chunks, int n,
                         int* __restrict__ off, int* __restrict__ ccnt,
                         int* __restrict__ glen,
                         long long* __restrict__ part) {
  const int j = blockIdx.x * SCAN_THREADS + threadIdx.x;
  int c = 0;
  if (j < n)
    for (int ch = 0; ch < chunks; ++ch) {
      off[(size_t)ch * n + j] = c;
      c += __ldg(cnt + (size_t)ch * n + j);
    }
  if (j < n) ccnt[j] = c;
  const int longest = __reduce_max_sync(REPRO_FULL_MASK, c);
  if ((threadIdx.x & 31) == 0 && j - (threadIdx.x & 31) < n)
    glen[j >> 5] = longest;
  long long total;
  block_exclusive_scan<long long>(c, &total);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// One block: gptr[g] = 32 · Σ_{g' < g} glen[g'] (group g's first entry);
// rows[0 .. n_delta) the Δ rows in order (delta may be null: none);
// totals = (entries, live entries, n_delta).
__global__ void __launch_bounds__(SCAN_THREADS)
relax_csc_gscan_kernel(const int* __restrict__ glen, int groups,
                       const long long* __restrict__ part, int parts,
                       const uint8_t* __restrict__ delta, int n,
                       int* __restrict__ gptr, int* __restrict__ rows,
                       long long* __restrict__ totals) {
  const int t = threadIdx.x;
  const int gper = (groups + SCAN_THREADS - 1) / SCAN_THREADS;
  const int ga = min(groups, t * gper), gb = min(groups, ga + gper);
  long long s = 0;
  for (int g = ga; g < gb; ++g) s += 32LL * glen[g];
  long long entries;
  long long at = block_exclusive_scan<long long>(s, &entries);
  for (int g = ga; g < gb; ++g) {
    gptr[g] = (int)at;  // valid while entries < 2^31 (the wrapper checks)
    at += 32LL * glen[g];
  }
  if (t == 0) gptr[groups] = (int)entries;
  const int rper = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const int ra = min(n, t * rper), rb = min(n, ra + rper);
  int m = 0;
  if (delta != nullptr)
    for (int r = ra; r < rb; ++r) m += delta[r] != 0;
  int n_delta;
  int pos = block_exclusive_scan<int>(m, &n_delta);
  if (delta != nullptr)
    for (int r = ra; r < rb; ++r)
      if (delta[r]) rows[pos++] = r;
  if (t == 0) {
    long long live = 0;
    for (int p = 0; p < parts; ++p) live += part[p];
    totals[0] = entries;
    totals[1] = live;
    totals[2] = n_delta;
  }
}

// Column j's live (k, a[k, j]) of chunk c go to entries off[c][j] .. of j
// in its group's block: entry t of column j sits at gptr[j / 32] + 32·t +
// j % 32, so a warp's 32 columns read their t-th entries in one coalesced
// load.  Slots past a column's last entry hold (0, +inf) (the wrapper's
// fill): they add +inf to a candidate and never lower a minimum.
__global__ void __launch_bounds__(CSC_COLS)
relax_csc_fill_kernel(const float* __restrict__ a, int n, int kpad,
                      const unsigned* __restrict__ bits,
                      const int* __restrict__ off,
                      const int* __restrict__ gptr, int2* __restrict__ lists) {
  const int j = blockIdx.x * CSC_COLS + threadIdx.x;
  if (j >= n) return;
  const int k0 = blockIdx.y * CSC_ROWS, k1 = min(n, k0 + CSC_ROWS);
  const uint4* mask = reinterpret_cast<const uint4*>(
      bits + (size_t)(j >> 5) * kpad + k0);
  int2* col = lists + __ldg(gptr + (j >> 5)) + (j & 31);
  int t = __ldg(off + (size_t)blockIdx.y * n + j);
  for (int kb = k0; kb < k1; kb += CSC_BATCH, mask += 2) {
    const uint4 lo = __ldg(mask), hi = __ldg(mask + 1);
    const unsigned w[CSC_BATCH] = {lo.x, lo.y, lo.z, lo.w,
                                   hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int u = 0; u < CSC_BATCH; ++u)
      if ((w[u] >> (j & 31)) & 1u) {  // rows past k1 have no bit set
        const int k = kb + u;
        col[32 * (size_t)t++] =
            make_int2(k, __float_as_int(a[(size_t)k * n + j]));
      }
  }
}

// The R staged rows' d[·, k] (row r at s[R·k + r]).
template <int R>
__device__ __forceinline__ void staged(const float* s, int k, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(s + 4 * k);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(s + 2 * k);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = s[k];
  }
}

template <int R>
__device__ __forceinline__ void relax_entry(const float* s, int2 e,
                                            float (&acc)[R]) {
  float v[R];
  staged<R>(s, e.x, v);
  const float w = __int_as_float(e.y);
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = fminf(acc[r], __fadd_rn(v[r], w));
}

// Block (x, y): the Δ rows rows[x·R ..] (the first n_delta of `rows`; R·n
// f32 of dynamic shared memory) against the column groups of split y; a
// warp takes one group of 32 columns at a time, a lane one column, and a
// lane past its column's ccnt entries loads and gathers nothing.
template <int R>
__global__ void __launch_bounds__(ARC_THREADS)
relax_arcs_kernel(const float* __restrict__ d, const int* __restrict__ gptr,
                  const int* __restrict__ ccnt,
                  const int2* __restrict__ lists,
                  const int* __restrict__ rows, int n_delta,
                  float* __restrict__ dnew, uint8_t* __restrict__ changed,
                  int n) {
  extern __shared__ __align__(16) float s_d[];  // s_d[R·k + r] = d[row_r, k]
  int row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = blockIdx.x * R + r;
    row[r] = i < n_delta ? __ldg(rows + i) : -1;
  }
  for (int k0 = threadIdx.x; k0 < n; k0 += STAGE_UNROLL * blockDim.x) {
    float v[STAGE_UNROLL][R];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = k0 + u * blockDim.x;
        v[u][r] = row[r] >= 0 && k < n ? __ldg(d + (size_t)row[r] * n + k)
                                       : INFINITY;
      }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k >= n) break;
      if constexpr (R == 4) {
        *reinterpret_cast<float4*>(s_d + 4 * k) =
            make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) s_d[R * k + r] = v[u][r];
      }
    }
  }
  __syncthreads();
  const int groups = (n + 31) / 32;
  const int per = (groups + gridDim.y - 1) / gridDim.y;
  const int g0 = blockIdx.y * per, g1 = min(groups, g0 + per);
  const int lane = threadIdx.x & 31;
  unsigned improved = 0u;  // bit r: row r lowered some entry
  for (int g = g0 + (threadIdx.x >> 5); g < g1; g += blockDim.x >> 5) {
    const int lo = __ldg(gptr + g), len = (__ldg(gptr + g + 1) - lo) >> 5;
    const int j = 32 * g + lane;
    const int mine = j < n ? __ldg(ccnt + j) : 0;
    const int2* col = lists + lo + lane;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = INFINITY;
    for (int i = 0; i < len; i += ARC_UNROLL) {  // uniform: len
      int2 e[ARC_UNROLL];
#pragma unroll
      for (int u = 0; u < ARC_UNROLL; ++u)
        if (i + u < mine) e[u] = __ldg(col + 32 * (i + u));
#pragma unroll
      for (int u = 0; u < ARC_UNROLL; ++u)
        if (i + u < mine) relax_entry<R>(s_d, e[u], acc);
    }
    if (j >= n) continue;
    float cur[R];
    staged<R>(s_d, j, cur);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row[r] < 0) continue;
      const float merged = fminf(cur[r], acc[r]);
      dnew[(size_t)row[r] * n + j] = merged;
      if (merged < cur[r]) improved |= 1u << r;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if ((improved >> r) & 1u) changed[row[r]] = 1;
}

// Block per row: rows outside Δ copy d to dnew.
__global__ void __launch_bounds__(COPY_THREADS)
relax_copy_rows_kernel(const float* __restrict__ d,
                       const uint8_t* __restrict__ delta,
                       float* __restrict__ dnew, int n) {
  const int row = blockIdx.x;
  if (delta[row]) return;
  const float* src = d + (size_t)row * n;
  float* dst = dnew + (size_t)row * n;
  for (int j = threadIdx.x; j < n; j += COPY_THREADS) dst[j] = __ldcs(src + j);
}

template <int R>
int relax_arcs(const float* d, const int* gptr, const int* ccnt,
               const int2* lists, const int* rows, int n_delta, float* dnew,
               uint8_t* changed, int n, int sms, cudaStream_t s) {
  const size_t smem = (size_t)R * n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        relax_arcs_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // few Δ rows: split the column groups too, so the grid fills the card
  const int row_blocks = (n_delta + R - 1) / R;
  const int groups = (n + 31) / 32;
  int splits = (2 * sms + row_blocks - 1) / row_blocks;
  splits = splits < 1 ? 1 : splits > groups ? groups : splits;
  relax_arcs_kernel<R><<<dim3(row_blocks, splits), ARC_THREADS, smem, s>>>(
      d, gptr, ccnt, lists, rows, n_delta, dnew, changed, n);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

// The arc-list route's pre-pass, before its one sync: a (n, n) f32; delta
// (n,) bool bytes or null; scratch bits (ceil(n / 32), ceil(n / 8) · 8)
// uint32 (16-byte aligned), cnt and
// off (ceil(n / 256), n) int32, glen (ceil(n / 32),) int32, part
// (ceil(n / 1024),) int64; out ccnt (n,) int32 (each column's entries),
// gptr (ceil(n / 32) + 1,) int32, rows (n,) int32, totals (3,) int64 =
// (list entries, live entries, Δ rows).
extern "C" int repro_relax_csc_scan(const void* a, int n, const void* delta,
                                    void* bits, void* cnt, void* off,
                                    void* ccnt, void* glen, void* part,
                                    void* gptr, void* rows, void* totals,
                                    void* stream) {
  if (n <= 0 || (n + 31) / 32 > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int words = (n + 31) / 32, chunks = (n + CSC_ROWS - 1) / CSC_ROWS;
  const int parts = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  relax_csc_count_kernel<<<dim3((n + CSC_COLS - 1) / CSC_COLS, chunks),
                           CSC_COLS, 0, s>>>(
      (const float*)a, n, (n + 7) / 8 * 8, (unsigned*)bits, (int*)cnt);
  REPRO_LAUNCH_CHECK();
  relax_csc_colscan_kernel<<<parts, SCAN_THREADS, 0, s>>>(
      (const int*)cnt, chunks, n, (int*)off, (int*)ccnt, (int*)glen,
      (long long*)part);
  REPRO_LAUNCH_CHECK();
  relax_csc_gscan_kernel<<<1, SCAN_THREADS, 0, s>>>(
      (const int*)glen, words, (const long long*)part, parts,
      (const uint8_t*)delta, n, (int*)gptr, (int*)rows, (long long*)totals);
  REPRO_LAUNCH_CHECK();
  return 0;
}

// ... and after it: lists (entries, 2) int32, filled with (0, +inf) by the
// caller, gets each column's (k, the f32 bits of a[k, j]) in ascending k.
extern "C" int repro_relax_csc_fill(const void* a, int n, const void* bits,
                                    const void* off, const void* gptr,
                                    void* lists, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + CSC_COLS - 1) / CSC_COLS,
                  (n + CSC_ROWS - 1) / CSC_ROWS);
  relax_csc_fill_kernel<<<grid, CSC_COLS, 0, (cudaStream_t)stream>>>(
      (const float*)a, n, (n + 7) / 8 * 8, (const unsigned*)bits,
      (const int*)off, (const int*)gptr, (int2*)lists);
  REPRO_LAUNCH_CHECK();
  return 0;
}

// The arc-list route's main pass.  d, dnew: (n, n) f32; gptr, ccnt and
// lists from the pre-pass; rows: (n,) int32 whose first n_delta are the Δ
// rows;
// delta: (n,) bool bytes; changed: (n,) bytes, zeroed by the caller; sms:
// the card's SMs; dnew must not alias d.  n <= 58,112 (one row of d in
// shared memory).
extern "C" int repro_relax_arcs(const void* d, const void* gptr,
                                const void* ccnt, const void* lists,
                                const void* rows,
                                int n_delta, const void* delta, void* dnew,
                                void* changed, int n, int sms, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  relax_copy_rows_kernel<<<n, COPY_THREADS, 0, s>>>(
      (const float*)d, (const uint8_t*)delta, (float*)dnew, n);
  REPRO_LAUNCH_CHECK();
  if (n_delta <= 0) return 0;
  const float* pd = (const float*)d;
  const int* pg = (const int*)gptr;
  const int* pc = (const int*)ccnt;
  const int2* pl = (const int2*)lists;
  const int* pr = (const int*)rows;
  float* po = (float*)dnew;
  uint8_t* pch = (uint8_t*)changed;
  constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory
  if ((size_t)n * 4 * sizeof(float) <= kMaxSmem)
    return relax_arcs<4>(pd, pg, pc, pl, pr, n_delta, po, pch, n, sms, s);
  if ((size_t)n * 2 * sizeof(float) <= kMaxSmem)
    return relax_arcs<2>(pd, pg, pc, pl, pr, n_delta, po, pch, n, sms, s);
  if ((size_t)n * sizeof(float) <= kMaxSmem)
    return relax_arcs<1>(pd, pg, pc, pl, pr, n_delta, po, pch, n, sms, s);
  return (int)cudaErrorInvalidValue;
}

// The tiled route.  d, a, dnew: (n, n) f32; delta: (n,) bool bytes;
// changed: (n,) bytes, zeroed by the caller — all contiguous; dnew must not
// alias d.
extern "C" int repro_relax_step(const void* d, const void* a,
                                const void* delta, void* dnew, void* changed,
                                int n, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + BN - 1) / BN, (n + BM - 1) / BM);
  relax_tiled_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)a, (const uint8_t*)delta, (float*)dnew,
      (uint8_t*)changed, n);
  REPRO_LAUNCH_CHECK();
  return 0;
}
