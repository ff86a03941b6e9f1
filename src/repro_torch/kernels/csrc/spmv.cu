// K3 / K4 / K5 / K6 — one CSR frontier step on the bool, min-plus,
// plus-times and max-plus carriers — and K7, the min-plus step over a
// tile-skip plan (below).
//
//   K3: out[b, v] = OR_{p in segments(v)} frontier[b, src_idx[p]] AND edge_val[p]
//   K4: out[b, v] = min_{p in segments(v)} frontier[b, src_idx[p]] + edge_val[p]
//   K5: out[b, v] = Σ_{p in segments(v)} frontier[b, src_idx[p]] × edge_val[p]
//   K6: out[b, v] = max_{p in segments(v)} frontier[b, src_idx[p]] + edge_val[p]
//
// the segments of v being its row of the sliced-ELL map (ell_slices /
// ell_rank) plus its row of the COO tail's single-width map (tail_ell /
// tail_src / tail_val).
//
// Replaces: src/repro/kernels/spmv.py, `csr_bool_spmv` (K3),
// `csr_minplus_spmv` (K4), `csr_plustimes_spmv` (K5) and `csr_maxplus_spmv`
// (K6), as driven by ops._csr_<carrier>_step (spine + tail).  The TPU's
// bool and plus-times kernels gather each arc chunk's frontier values, skip
// a chunk whose sources are all inactive (`pl.when(act_ref[c] != 0)`), and
// scatter by destination through a one-hot MXU product; its min-plus and
// max-plus kernels reduce by destination through a masked broadcast-min or
// -max over column tiles with the whole frontier in VMEM.  A one-hot
// scatter is O(|E|·n) and a (B, n) f32 frontier is 128 MB at the CSR
// paths' shapes (B = 32, n = 2^20), so the port pulls by destination
// instead.
//
// What bounds them on the H100: device memory.  The least work reads the
// frontier once, the live sources' arcs once and writes the output once;
// at the batch layer's first step almost no source is active.
//
// Design.  All four read the CSR's derived, ELL-ordered arrays
// (core.sparse._ell_order, built once per CSR on the card): ell_src[k] is
// the source of slot k of the slices laid end to end (-1 for a sentinel),
// ell_val[k] its value (K4-K6), and a work list of warp items over
// *pieces*: a row of capacity <= 16 is one piece and 32 / cap such rows
// share an item (one 32-slot load); a wider row is cut into pieces of up to
// ELL_SEG slots, ending at its last live slot, one item each, so the hub
// rungs spread over every SM.  All slices are one launch.  So a warp's 32
// slots cost two coalesced loads (through the arc positions they would
// cost one coalesced and two scattered), and no slot past a row's last
// arc is read.
//
// K4, K5 and K6 are one template on the carrier's (⊕, ⊗) (MinPlusOp,
// PlusTimesOp, MaxPlusOp below; lanes = batch rows, NB = ceil(B / 32)
// values a lane):
//  1. ell_transpose_kernel reads the (B, n) frontier once, writes the (n, B)
//     rows of the *active* sources only (a value other than the ⊕-zero in
//     some batch row) and a bitmask of them (n / 8 bytes, cached in L1);
//  2. ell_pull_kernel, one warp per item: each lane loads a slot's source
//     and its activity bit, the warp ballots "live and active", and only
//     those arcs are gathered (one coalesced B-value row each, eight in
//     flight).  Skipping is exact: an inactive source's values are the
//     ⊕-zero in every row, and ⊗ keeps them so for every finite weight
//     (+inf + w = +inf under a min; 0 × w = ±0 under a sum that starts at
//     +0.0; -inf + w = -inf under a max), so its arc cannot change a
//     result.  Each piece's ⊕ goes to part[piece]; a per-piece flag says
//     whether any arc was live, so a dead piece writes nothing else;
//  3. ell_gather_kernel, one warp per 32 vertices: lanes (one a vertex) find
//     the vertices with a live piece or an active COO-tail arc; for each of
//     those the warp (lanes = batch rows) folds its row's live pieces and
//     then its tail arcs, and every vertex's B values leave through a
//     shared-memory tile as coalesced (B, n) stores.
// The order of the ⊕ is fixed by the data, never by scheduling: within a
// row, the positions of each piece in slot order from the ⊕-zero; then the
// pieces in order; then the COO tail's positions in order.  No atomics, so
// repeated runs give identical bits (spmv.ell_step_in_kernel_order is the
// same order in PyTorch).  Min and max are exact in any order, so K4 and K6
// are bit-identical to the plain step and to JAX whatever the data (up to
// the sign of a zero: fminf/fmaxf may return either of a -0.0 and +0.0
// tie, which no served path sends, its weights being 1..9).  The plain
// plus-times step sums in torch.sum's order instead, so K5 equals it (and
// the JAX steps) exactly while every partial sum is an integer below 2^24 —
// f32 adds integers exactly there, whatever the order.  The service's EDB
// is integral and path counts are integers, so that is the contract (the
// JAX package's plus-times kernel states the same one); non-integer sums
// may differ from the plain step in the last bits.
//
// K3 (lanes = slots, W = ceil(B / 32) words a vertex):
//  1. k3_pack_kernel packs the (B, n) bool frontier into (n, W) uint32
//     words, bit b % 32 of word b / 32 (4 MiB a word at n = 2^20, resident
//     in L2), plus the same activity bitmask as K4-K6;
//  2. k3_pull_kernel, one warp per item: each lane takes one slot and, if
//     its source is active, ORs in the source's W words; the lanes of one
//     row OR-reduce by __shfl_xor_sync (a capacity below 32 puts 32 / cap
//     rows in a warp), and the row's first lane ORs the result into its
//     row's words (an atomicOr where a hub's pieces meet);
//  3. k3_unpack_kernel, 256 vertices a block: each vertex's row words
//     (through ell_rank), its COO tail's words ORed in shared memory, then
//     unpacked into the (B, n) bool output in coalesced runs.
// OR is order-free, so K3 is bit-identical to the plain step and to JAX
// for every B.  All four take B <= 128; the wrappers split larger batches.
#include "common.cuh"

namespace {

constexpr int K35_THREADS = 256;  // 8 warps a block
constexpr int K35_UNROLL = 8;     // gathers in flight per lane

// A carrier's (⊕, ⊗): zero() is the ⊕ identity ("no fact"), live(x) says
// x is not it, combine(f, w) is ⊗ of a frontier value and an arc value,
// reduce is ⊕.
struct MinPlusOp {
  using T = float;
  static __device__ __forceinline__ T zero() { return INFINITY; }
  static __device__ __forceinline__ bool live(T w) { return w != INFINITY; }
  static __device__ __forceinline__ T combine(T f, T w) { return __fadd_rn(f, w); }
  static __device__ __forceinline__ T reduce(T a, T b) { return fminf(a, b); }
};

struct MaxPlusOp {
  using T = float;
  static __device__ __forceinline__ T zero() { return -INFINITY; }
  static __device__ __forceinline__ bool live(T w) { return w != -INFINITY; }
  static __device__ __forceinline__ T combine(T f, T w) { return __fadd_rn(f, w); }
  static __device__ __forceinline__ T reduce(T a, T b) { return fmaxf(a, b); }
};

struct PlusTimesOp {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ bool live(T w) { return w != 0.0f; }
  static __device__ __forceinline__ T combine(T f, T w) { return __fmul_rn(f, w); }
  static __device__ __forceinline__ T reduce(T a, T b) { return __fadd_rn(a, b); }
};

// Is source s (-1: a sentinel slot) active: live in some batch row?
__device__ __forceinline__ bool k35_active(const unsigned* __restrict__ act,
                                           int s) {
  return s >= 0 && ((__ldg(act + (s >> 5)) >> (s & 31)) & 1u);
}

// acc[q] = acc[q] ⊕ (fT[s_j][b] ⊗ w_j) for the set bits j of `live` in
// ascending order, (s_j, w_j) being lane j's (s, w); lane owns batch rows
// lane + 32q.  `live` is warp-uniform and all 32 lanes call.
template <class Op, int NB>
__device__ __forceinline__ void ell_add_arcs(unsigned live, int s, float w,
                                             const float* __restrict__ fT,
                                             int B, int lane,
                                             float (&acc)[NB]) {
  while (live) {
    float v[K35_UNROLL][NB], wj[K35_UNROLL];
    bool ok[K35_UNROLL];
#pragma unroll
    for (int u = 0; u < K35_UNROLL; ++u) {
      ok[u] = live != 0u;
      const int j = ok[u] ? __ffs(live) - 1 : 0;
      live &= live - 1u;
      const int sj = __shfl_sync(REPRO_FULL_MASK, s, j);
      wj[u] = __shfl_sync(REPRO_FULL_MASK, w, j);
      const float* row = fT + (size_t)(ok[u] ? sj : 0) * B;
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int b = lane + 32 * q;
        v[u][q] = ok[u] && b < B ? __ldg(row + b) : Op::zero();
      }
    }
#pragma unroll
    for (int u = 0; u < K35_UNROLL; ++u)
      if (ok[u])
#pragma unroll
        for (int q = 0; q < NB; ++q)
          acc[q] = Op::reduce(acc[q], Op::combine(v[u][q], wj[u]));
  }
}

// acc[q] = acc[q] ⊕ part[k0 + j][b] for the set bits j of `live` in
// ascending order.
template <class Op, int NB>
__device__ __forceinline__ void ell_add_pieces(unsigned live, int k0,
                                               const float* __restrict__ part,
                                               int B, int lane,
                                               float (&acc)[NB]) {
  while (live) {
    float v[K35_UNROLL][NB];
    bool ok[K35_UNROLL];
#pragma unroll
    for (int u = 0; u < K35_UNROLL; ++u) {
      ok[u] = live != 0u;
      const int j = ok[u] ? __ffs(live) - 1 : 0;
      live &= live - 1u;
      const float* row = part + (size_t)(k0 + j) * B;
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int b = lane + 32 * q;
        v[u][q] = ok[u] && b < B ? __ldg(row + b) : Op::zero();
      }
    }
#pragma unroll
    for (int u = 0; u < K35_UNROLL; ++u)
      if (ok[u])
#pragma unroll
        for (int q = 0; q < NB; ++q) acc[q] = Op::reduce(acc[q], v[u][q]);
  }
}

// Block (32, 8), 32 vertices: fT rows of the active vertices, and their
// activity bits (one word a block).
template <class Op, int NB>
__global__ void __launch_bounds__(K35_THREADS)
ell_transpose_kernel(const float* __restrict__ f, int B, int n,
                     float* __restrict__ fT, unsigned* __restrict__ act) {
  __shared__ float tile[32 * NB][33];
  __shared__ unsigned mask;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int v0 = blockIdx.x * 32, x = v0 + tx;
  if (tx == 0 && ty == 0) mask = 0u;
  __syncthreads();
  bool any = false;
  for (int b = ty; b < B; b += blockDim.y) {
    const float val = x < n ? f[(size_t)b * n + x] : Op::zero();
    tile[b][tx] = val;
    any |= Op::live(val);
  }
  if (any) atomicOr(&mask, 1u << tx);
  __syncthreads();
  const unsigned m = mask;
  if (tx == 0 && ty == 0) act[blockIdx.x] = m;
  for (int j = ty; j < 32; j += blockDim.y) {
    if (!((m >> j) & 1u)) continue;
    float* row = fT + (size_t)(v0 + j) * B;
    for (int b = tx; b < B; b += 32) row[b] = tile[b][j];
  }
}

// One warp per item (first slot, first piece, first row, pieces | len << 6).
template <class Op, int NB>
__global__ void __launch_bounds__(K35_THREADS)
ell_pull_kernel(const int4* __restrict__ items, int n_items,
                const int* __restrict__ ell_src,
                const float* __restrict__ ell_val,
                const unsigned* __restrict__ act,
                const float* __restrict__ fT, int B,
                float* __restrict__ part, uint8_t* __restrict__ live_piece) {
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_items) return;  // uniform across the warp
  const int4 it = __ldg(items + warp);
  const int lo = it.x, k0 = it.y, np = it.w & 63, len = it.w >> 6;
  float acc[NB];
  if (np > 1) {  // np rows of len <= 16 slots (a power of two): one load
    int s = -1;
    float w = Op::zero();
    if (lane < np * len) s = __ldcs(ell_src + lo + lane);
    const bool a = k35_active(act, s);
    if (a) w = __ldcs(ell_val + lo + lane);
    const unsigned live = __ballot_sync(REPRO_FULL_MASK, a);
    const unsigned lmask = (1u << len) - 1u;
    if (lane < np)
      live_piece[k0 + lane] = ((live >> (lane * len)) & lmask) != 0u;
    unsigned rest = live;
    while (rest) {  // uniform: the pieces with a live arc, in order
      const int t = (__ffs(rest) - 1) / len;
      const unsigned bits = live & (lmask << (t * len));
      rest &= ~bits;
#pragma unroll
      for (int q = 0; q < NB; ++q) acc[q] = Op::zero();
      ell_add_arcs<Op, NB>(bits, s, w, fT, B, lane, acc);
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int b = lane + 32 * q;
        if (b < B) part[(size_t)(k0 + t) * B + b] = acc[q];
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < NB; ++q) acc[q] = Op::zero();
  unsigned any = 0u;
  for (int c0 = lo; c0 < lo + len; c0 += 32) {
    const int c = c0 + lane;
    int s = -1;
    float w = Op::zero();
    if (c < lo + len) s = __ldcs(ell_src + c);
    const bool a = k35_active(act, s);
    if (a) w = __ldcs(ell_val + c);
    const unsigned live = __ballot_sync(REPRO_FULL_MASK, a);
    any |= live;
    ell_add_arcs<Op, NB>(live, s, w, fT, B, lane, acc);
  }
  if (lane == 0) live_piece[k0] = any != 0u;
  if (any)
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int b = lane + 32 * q;
      if (b < B) part[(size_t)k0 * B + b] = acc[q];
    }
}

// One warp per 32 vertices; 8 / NB warps a block (a 33 KB tile).
template <class Op, int NB>
__global__ void __launch_bounds__(K35_THREADS)
ell_gather_kernel(const float* __restrict__ part,
                  const uint8_t* __restrict__ live_piece,
                  const int* __restrict__ row_piece,
                  const int* __restrict__ rank,
                  const int* __restrict__ tail_ell, int tdc,
                  const int* __restrict__ tail_src,
                  const float* __restrict__ tail_val,
                  const unsigned* __restrict__ act,
                  const float* __restrict__ fT, int B, int n,
                  float* __restrict__ out) {
  constexpr int GW = 8 / NB;
  __shared__ float tile[GW][32][32 * NB + 1];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int v0 = (blockIdx.x * GW + wid) * 32;
  if (v0 >= n) return;  // uniform across the warp; no block barrier below
  const int v = v0 + lane;
  const int nv = min(32, n - v0);
  int plo = 0, phi = 0;
  bool need = false;
  if (lane < nv) {
    const int r = __ldg(rank + v);
    plo = __ldg(row_piece + r);
    phi = __ldg(row_piece + r + 1);
    need = phi - plo > 1 || (phi - plo == 1 && __ldg(live_piece + plo));
  }
  unsigned tail_need = 0u;  // bit i: vertex v0 + i has an active tail arc
  for (int i = lane; i < nv * tdc; i += 32) {
    const int p = __ldg(tail_ell + (size_t)v0 * tdc + i);
    if (Op::live(__ldg(tail_val + p)) && k35_active(act, __ldg(tail_src + p)))
      tail_need |= 1u << (i / tdc);
  }
  tail_need = __reduce_or_sync(REPRO_FULL_MASK, tail_need);
  need |= ((tail_need >> lane) & 1u) != 0u;
  float(*my)[32 * NB + 1] = tile[wid];
  for (int b = 0; b < B; ++b) my[lane][b] = Op::zero();
  __syncwarp();
  unsigned todo = __ballot_sync(REPRO_FULL_MASK, need);
  while (todo) {  // uniform
    const int j = __ffs(todo) - 1;
    todo &= todo - 1u;
    const int pl = __shfl_sync(REPRO_FULL_MASK, plo, j);
    const int ph = __shfl_sync(REPRO_FULL_MASK, phi, j);
    float acc[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) acc[q] = Op::zero();
    for (int k0 = pl; k0 < ph; k0 += 32) {  // the row's pieces, in order
      const bool lv = k0 + lane < ph && __ldg(live_piece + k0 + lane);
      ell_add_pieces<Op, NB>(__ballot_sync(REPRO_FULL_MASK, lv), k0, part, B,
                             lane, acc);
    }
    const int* tl = tail_ell + (size_t)(v0 + j) * tdc;
    for (int c0 = 0; c0 < tdc; c0 += 32) {  // then its tail, in order
      int s = -1;
      float w = Op::zero();
      if (c0 + lane < tdc) {
        const int p = __ldg(tl + c0 + lane);
        w = __ldg(tail_val + p);
        if (Op::live(w)) s = __ldg(tail_src + p);
      }
      const bool a = k35_active(act, s);
      ell_add_arcs<Op, NB>(__ballot_sync(REPRO_FULL_MASK, a), s, w, fT, B,
                           lane, acc);
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) my[j][lane + 32 * q] = acc[q];
  }
  __syncwarp();
  if (lane < nv)
    for (int b = 0; b < B; ++b) out[(size_t)b * n + v] = my[lane][b];
}

template <class Op, int NB>
int ell_step(const float* f, int B, int n, const int* ell_src,
             const float* ell_val, const int4* items, int n_items,
             const int* row_piece, const int* rank, const int* tail_ell,
             int tdc, const int* tail_src, const float* tail_val, float* fT,
             unsigned* act, float* part, uint8_t* live_piece, float* out,
             cudaStream_t s) {
  ell_transpose_kernel<Op, NB><<<(n + 31) / 32, dim3(32, 8), 0, s>>>(
      f, B, n, fT, act);
  REPRO_LAUNCH_CHECK();
  if (n_items > 0) {
    const unsigned blocks = (unsigned)((n_items + 7) / 8);
    ell_pull_kernel<Op, NB><<<blocks, K35_THREADS, 0, s>>>(
        items, n_items, ell_src, ell_val, act, fT, B, part, live_piece);
    REPRO_LAUNCH_CHECK();
  }
  constexpr int GW = 8 / NB;
  const unsigned gblocks = (unsigned)((n + 32 * GW - 1) / (32 * GW));
  ell_gather_kernel<Op, NB><<<gblocks, 32 * GW, 0, s>>>(
      part, live_piece, row_piece, rank, tail_ell, tdc, tail_src, tail_val,
      act, fT, B, n, out);
  REPRO_LAUNCH_CHECK();
  return 0;
}

template <class Op>
int ell_step_dispatch(const void* f, int B, int n, const int* ell_src,
                      const void* ell_val, const void* items, int n_items,
                      const int* row_piece, const int* rank,
                      const int* tail_ell, int tdc, const int* tail_src,
                      const void* tail_val, void* fT, void* act, void* part,
                      void* live, void* out, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (B > 128) return (int)cudaErrorInvalidValue;  // the wrapper splits B
  const float* pf = (const float*)f;
  const float* pv = (const float*)ell_val;
  const int4* it = (const int4*)items;
  const float* tv = (const float*)tail_val;
  float *pT = (float*)fT, *pp = (float*)part, *po = (float*)out;
  unsigned* pa = (unsigned*)act;
  uint8_t* pl = (uint8_t*)live;
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 32)
    return ell_step<Op, 1>(pf, B, n, ell_src, pv, it, n_items, row_piece,
                           rank, tail_ell, tdc, tail_src, tv, pT, pa, pp, pl,
                           po, s);
  if (B <= 64)
    return ell_step<Op, 2>(pf, B, n, ell_src, pv, it, n_items, row_piece,
                           rank, tail_ell, tdc, tail_src, tv, pT, pa, pp, pl,
                           po, s);
  return ell_step<Op, 4>(pf, B, n, ell_src, pv, it, n_items, row_piece, rank,
                         tail_ell, tdc, tail_src, tv, pT, pa, pp, pl, po, s);
}

// 256 vertices a block, lane = vertex: the (n, W) words and activity bits;
// the grid also zeroes the pull's row words.
template <int W>
__global__ void __launch_bounds__(K35_THREADS)
k3_pack_kernel(const uint8_t* __restrict__ f, int B, int n,
               unsigned* __restrict__ fw, unsigned* __restrict__ act,
               unsigned* __restrict__ roww, size_t roww_words) {
  const int v = blockIdx.x * K35_THREADS + threadIdx.x;
  unsigned w[W];
  bool any = false;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    w[q] = 0u;
    if (v < n) {
      const int bq = min(32, B - 32 * q);
      for (int k = 0; k < bq; ++k)
        w[q] |= (unsigned)(f[(size_t)(32 * q + k) * n + v] != 0) << k;
      fw[(size_t)v * W + q] = w[q];
    }
    any |= w[q] != 0u;
  }
  const unsigned m = __ballot_sync(REPRO_FULL_MASK, any);
  if ((threadIdx.x & 31) == 0 && v < n) act[v >> 5] = m;
  for (size_t i = (size_t)blockIdx.x * K35_THREADS + threadIdx.x;
       i < roww_words; i += (size_t)gridDim.x * K35_THREADS)
    roww[i] = 0u;
}

// One warp per item; lanes = slots.
template <int W>
__global__ void __launch_bounds__(K35_THREADS)
k3_pull_kernel(const int4* __restrict__ items, int n_items,
               const int* __restrict__ ell_src,
               const unsigned* __restrict__ act,
               const unsigned* __restrict__ fw, unsigned* __restrict__ roww) {
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_items) return;  // uniform across the warp
  const int4 it = __ldg(items + warp);
  const int lo = it.x, r0 = it.z, np = it.w & 63, len = it.w >> 6;
  const int hi = lo + (np > 1 ? np * len : len);
  unsigned acc[W];
#pragma unroll
  for (int q = 0; q < W; ++q) acc[q] = 0u;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int c = c0 + lane;
    const int s = c < hi ? __ldcs(ell_src + c) : -1;
    if (k35_active(act, s)) {
      const unsigned* ws = fw + (size_t)s * W;
#pragma unroll
      for (int q = 0; q < W; ++q) acc[q] |= __ldg(ws + q);
    }
  }
  const int width = np > 1 ? len : 32;  // lanes that share a row
  for (int off = width >> 1; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < W; ++q)
      acc[q] |= __shfl_xor_sync(REPRO_FULL_MASK, acc[q], off);
  const int t = lane / width;
  if (lane % width == 0 && t < np) {
    unsigned* dst = roww + (size_t)(r0 + t) * W;
#pragma unroll
    for (int q = 0; q < W; ++q)
      if (acc[q]) atomicOr(dst + q, acc[q]);
  }
}

// 256 vertices a block: row words through ell_rank, the COO tail ORed in
// shared memory, then bit b of each vertex to out[b, v] (coalesced bytes).
template <int W>
__global__ void __launch_bounds__(K35_THREADS)
k3_unpack_kernel(const unsigned* __restrict__ roww,
                 const int* __restrict__ rank,
                 const int* __restrict__ tail_ell, int tdc,
                 const int* __restrict__ tail_src,
                 const uint8_t* __restrict__ tail_val,
                 const unsigned* __restrict__ act,
                 const unsigned* __restrict__ fw, int B, int n,
                 uint8_t* __restrict__ out) {
  __shared__ unsigned sw[W][K35_THREADS];
  const int t = threadIdx.x;
  const int v0 = blockIdx.x * K35_THREADS;
  const int nv = min(K35_THREADS, n - v0);
  const unsigned* rw = roww + (size_t)(t < nv ? __ldg(rank + v0 + t) : 0) * W;
#pragma unroll
  for (int q = 0; q < W; ++q) sw[q][t] = t < nv ? __ldg(rw + q) : 0u;
  __syncthreads();
  for (int i = t; i < nv * tdc; i += K35_THREADS) {
    const int p = __ldg(tail_ell + (size_t)v0 * tdc + i);
    if (!__ldg(tail_val + p)) continue;
    const int s = __ldg(tail_src + p);
    if (!k35_active(act, s)) continue;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const unsigned x = __ldg(fw + (size_t)s * W + q);
      if (x) atomicOr(&sw[q][i / tdc], x);
    }
  }
  __syncthreads();
  if (t < nv)
    for (int b = 0; b < B; ++b)
      out[(size_t)b * n + v0 + t] = (uint8_t)((sw[b >> 5][t] >> (b & 31)) & 1u);
}

template <int W>
int k3_step(const uint8_t* f, int B, int n, const int* ell_src,
            const int4* items, int n_items, int n_rows, const int* rank,
            const int* tail_ell, int tdc, const int* tail_src,
            const uint8_t* tail_val, unsigned* fw, unsigned* act,
            unsigned* roww, uint8_t* out, cudaStream_t s) {
  const unsigned vblocks = (unsigned)((n + K35_THREADS - 1) / K35_THREADS);
  k3_pack_kernel<W><<<vblocks, K35_THREADS, 0, s>>>(f, B, n, fw, act, roww,
                                                    (size_t)n_rows * W);
  REPRO_LAUNCH_CHECK();
  if (n_items > 0) {
    const unsigned blocks = (unsigned)((n_items + 7) / 8);
    k3_pull_kernel<W><<<blocks, K35_THREADS, 0, s>>>(items, n_items, ell_src,
                                                     act, fw, roww);
    REPRO_LAUNCH_CHECK();
  }
  k3_unpack_kernel<W><<<vblocks, K35_THREADS, 0, s>>>(
      roww, rank, tail_ell, tdc, tail_src, tail_val, act, fw, B, n, out);
  REPRO_LAUNCH_CHECK();
  return 0;
}

// ---------------------------------------------------------------------------
// K7 — the min-plus step over a tile-skip plan (csr_minplus_tiled_step).
//
//   out[b, v] = min( min_{planned arcs p, col_idx[p] = v} frontier[b, src[p]] + val[p],
//                    its COO-tail row as in K4 )
//
// the planned arcs being the ones the plan's (tile, chunk) items visit: the
// live arcs of chunk c whose destination lies in tile t, for each item
// (t, c).
//
// Replaces: src/repro/kernels/spmv.py, `csr_minplus_spmv_tiled`, as driven
// by ops._csr_minplus_step on a CSR that carries a plan (plus the untiled
// tail pass JAX launches after it: here the tail folds into the same
// step).  The TPU kernel walks the (tile, chunk) worklist in order on one
// core, revisiting each (B, bn) output block in VMEM and computing a
// (B, chunk, bn) masked broadcast-min per item.  The plan is cut for the
// TPU's tiles and the arcs are stored in (src, dst) order, so that walk
// reads an arc chunk once for every tile it hits (the power-law smoke
// graph: about 14M items of 32 arcs for 16M arcs).  On Hopper blocks run
// in no order and nothing carries between them, so:
//
//  * K7 reads the plan's own arcs once each, in destination order
//    (core.sparse._tile_order, built on the card from the spine and the
//    plan): tile_src / tile_dst / tile_val, 12 bytes an arc, and work
//    units (tile, first arc, end arc, flags) of at most TILE_UNIT arcs of
//    one column tile, one CTA per (unit, 32 batch rows).  Every tile has a
//    unit; a hub's tile spreads over many.
//  * ell_transpose_kernel (K4-K6's) writes the (n, B) rows of the active
//    sources and their bitmask.  Each warp takes a contiguous run of its
//    unit's arcs, 32 at a time in coalesced loads (the source; the
//    destination and value only where the source is active), ballots the
//    active arcs and gathers only their rows, eight in flight (lanes =
//    batch rows).  Skipping is exact: an inactive source is +inf in every
//    row, and +inf + w = +inf for every finite w.  (Loading four such
//    groups' sources at once took the seed step from 0.261 to 0.255 ms on
//    an H100 but an all-finite one from 1.29 to 1.66 ms, so the loads go
//    one group at a time.)
//  * The arcs come sorted by destination, so a lane keeps a running min for
//    the current column in a register and flushes it into the CTA's
//    (32, bn + 1) f32 accumulator in shared memory (row pitch bn + 1: the
//    32 lanes, one batch row each, hit 32 banks) when the column changes.
//    A column inside a warp's run is that warp's alone: a plain min.  Only
//    the run's first and last columns, where two warps' runs can meet,
//    take an order-free atomic min on the f32 bits.
//  * A tile's first unit then folds the COO tail over tail_ell for the
//    tile's columns: lanes (one a column) find the columns with a live
//    tail arc from an active source, and the warp (lanes = batch rows)
//    folds each of those.
//  * A unit that covers its whole tile stores its block; the units of a
//    split tile meet in device memory through the same atomic min, on
//    blocks that tile_fill_kernel sets to +inf first (only the split
//    tiles': a fill of the whole output took 0.04 ms a step on the smoke
//    graph, where 196 of 8,192 tiles are split).  Columns at or past n
//    (the last tile may be partial) are masked.
// Min is order-free and idempotent, so K7 is bit-identical to the plain
// step (up to the sign of a zero, as K4).
//
// What bounds it on the H100: device memory.  The least work reads the
// frontier once, the active sources' arcs once and writes the output once;
// K7 also streams every planned arc's source (12 bytes an arc where it is
// active) and the unit table.
constexpr int TILED_THREADS = 256;  // 8 warps per unit
constexpr int TILED_ROWS = 32;      // batch rows per CTA (one per lane)
constexpr int UNIT_FIRST = 1;       // tile_units flags, as core.sparse's
constexpr int UNIT_WHOLE = 2;

// min on f32 through the integer atomics: non-negative floats order like
// their int bits, negative ones reverse like their unsigned bits.
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (v >= 0.0f)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// Fold a lane's running min for column `col` into its accumulator row: a
// plain min where the column is this warp's alone, the atomic min where
// another warp's run may share it (skipped when it would not lower the
// value: values only fall, so a stale read never skips wrongly).
__device__ __forceinline__ void tile_flush(float* my, int col, float run,
                                           bool shared) {
  if (col < 0 || run == INFINITY) return;
  if (!shared)
    my[col] = fminf(my[col], run);
  else if (run < my[col])
    atomic_min_f32(my + col, run);
}

// Fold one group of 32 arcs into a warp's running min (cur, run) for its
// current column, flushing at each change of column: `live` is the ballot
// of the lanes whose arc is active, lane j holding its arc's source s,
// value w and column col; lanes = batch rows (b, row_ok), eight gathers in
// flight.
__device__ __forceinline__ void tile_group(unsigned live, int s, float w,
                                           int col,
                                           const float* __restrict__ fT,
                                           int B, int b, bool row_ok,
                                           int cfirst, int clast, float* my,
                                           int& cur, float& run) {
  while (live) {  // uniform: the active arcs in order
    float v[K35_UNROLL];
    int cj[K35_UNROLL];
#pragma unroll
    for (int q = 0; q < K35_UNROLL; ++q) {
      const bool ok = live != 0u;
      const int jj = ok ? __ffs(live) - 1 : 0;
      live &= live - 1u;
      const int sj = __shfl_sync(REPRO_FULL_MASK, s, jj);
      const float wj = __shfl_sync(REPRO_FULL_MASK, w, jj);
      const int cq = __shfl_sync(REPRO_FULL_MASK, col, jj);
      cj[q] = ok ? cq : -1;
      v[q] = ok && row_ok ? __fadd_rn(__ldg(fT + (size_t)sj * B + b), wj)
                          : INFINITY;
    }
#pragma unroll
    for (int q = 0; q < K35_UNROLL; ++q) {
      if (cj[q] < 0) break;  // uniform: the rest are past the ballot
      if (cj[q] != cur) {
        tile_flush(my, cur, run, cur == cfirst || cur == clast);
        cur = cj[q];
        run = v[q];
      } else {
        run = fminf(run, v[q]);
      }
    }
  }
}

// One CTA per unit: the first unit of a split tile sets the tile's (B, bn)
// block of out to +inf, the other units exit.
__global__ void __launch_bounds__(TILED_THREADS)
tile_fill_kernel(const int4* __restrict__ units, int bn, int n, int B,
                 float* __restrict__ out) {
  const int4 u = __ldg(units + blockIdx.x);
  if ((u.w & (UNIT_FIRST | UNIT_WHOLE)) != UNIT_FIRST) return;  // uniform
  const int col0 = u.x * bn, ncols = min(bn, n - col0);
  const int shift = __ffs(bn) - 1;  // bn is a power of two
  for (int k = threadIdx.x; k < B * bn; k += blockDim.x) {
    const int r = k >> shift, c = k & (bn - 1);
    if (c < ncols) out[(size_t)r * n + col0 + c] = INFINITY;
  }
}

// One CTA per (unit, 32 batch rows): units[u] = (tile, lo, hi, flags).
__global__ void __launch_bounds__(TILED_THREADS)
minplus_tile_kernel(const int4* __restrict__ units, int bn, int n,
                    const int* __restrict__ tsrc, const int* __restrict__ tdst,
                    const float* __restrict__ tval,
                    const int* __restrict__ tail_ell, int tdc,
                    const int* __restrict__ tail_src,
                    const float* __restrict__ tail_val,
                    const unsigned* __restrict__ act,
                    const float* __restrict__ fT, int B,
                    float* __restrict__ out) {
  extern __shared__ float acc[];  // TILED_ROWS x (bn + 1)
  const int4 u = __ldg(units + blockIdx.x);
  const int col0 = u.x * bn, lo = u.y, hi = u.z;
  const int pitch = bn + 1;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b0 = blockIdx.y * TILED_ROWS, b = b0 + lane;
  const bool row_ok = b < B;
  float* my = acc + lane * pitch;
  for (int k = threadIdx.x; k < TILED_ROWS * pitch; k += blockDim.x)
    acc[k] = INFINITY;
  __syncthreads();

  // this warp's run of the unit's arcs
  const long long len = hi - lo;
  const int rlo = lo + (int)(len * wid / nwarps);
  const int rhi = lo + (int)(len * (wid + 1) / nwarps);
  if (rlo < rhi) {  // uniform across the warp
    const int cfirst = __ldg(tdst + rlo) - col0;
    const int clast = __ldg(tdst + rhi - 1) - col0;
    int cur = -1;
    float run = INFINITY;
    for (int c0 = rlo; c0 < rhi; c0 += 32) {
      const int j = c0 + lane;
      const int s = j < rhi ? __ldcs(tsrc + j) : -1;
      const bool a = k35_active(act, s);
      const unsigned live = __ballot_sync(REPRO_FULL_MASK, a);
      if (!live) continue;  // uniform
      const float w = a ? __ldcs(tval + j) : 0.0f;
      const int col = a ? __ldcs(tdst + j) - col0 : 0;
      tile_group(live, s, w, col, fT, B, b, row_ok, cfirst, clast, my, cur,
                 run);
    }
    tile_flush(my, cur, run, cur == cfirst || cur == clast);
  }

  const int ncols = min(bn, n - col0);
  if (u.w & UNIT_FIRST) {  // the tile's first unit folds the COO tail
    __syncthreads();
    for (int c0 = wid * 32; c0 < ncols; c0 += nwarps * 32) {
      const int nv = min(32, ncols - c0);
      const int* tl0 = tail_ell + (size_t)(col0 + c0) * tdc;
      unsigned need = 0u;  // bit i: column c0 + i has an active tail arc
      for (int i = lane; i < nv * tdc; i += 32) {
        const int p = __ldg(tl0 + i);
        if (__ldg(tail_val + p) != INFINITY &&
            k35_active(act, __ldg(tail_src + p)))
          need |= 1u << (i / tdc);
      }
      need = __reduce_or_sync(REPRO_FULL_MASK, need);
      while (need) {  // uniform; this warp owns column c0 + jc now
        const int jc = __ffs(need) - 1;
        need &= need - 1u;
        const int* tl = tl0 + (size_t)jc * tdc;
        float a = my[c0 + jc];
        for (int q0 = 0; q0 < tdc; q0 += 32) {
          int s = -1;
          float w = INFINITY;
          if (q0 + lane < tdc) {
            const int p = __ldg(tl + q0 + lane);
            w = __ldg(tail_val + p);
            if (w != INFINITY) s = __ldg(tail_src + p);
          }
          unsigned live = __ballot_sync(REPRO_FULL_MASK, k35_active(act, s));
          while (live) {
            const int jj = __ffs(live) - 1;
            live &= live - 1u;
            const int sj = __shfl_sync(REPRO_FULL_MASK, s, jj);
            const float wj = __shfl_sync(REPRO_FULL_MASK, w, jj);
            if (row_ok)
              a = fminf(a, __fadd_rn(__ldg(fT + (size_t)sj * B + b), wj));
          }
        }
        my[c0 + jc] = a;
      }
    }
  }
  __syncthreads();
  const int rows = min(TILED_ROWS, B - b0);
  const bool whole = (u.w & UNIT_WHOLE) != 0;
  const int shift = __ffs(bn) - 1;  // bn is a power of two
  for (int k = threadIdx.x; k < rows * bn; k += blockDim.x) {
    const int r = k >> shift, c = k & (bn - 1);
    if (c >= ncols) continue;
    const float a = acc[r * pitch + c];
    float* o = out + (size_t)(b0 + r) * n + col0 + c;
    if (whole)
      *o = a;
    else if (a != INFINITY)
      atomic_min_f32(o, a);
  }
}

}  // namespace

// K3.  f: (B, n) bool frontier (0/1 bytes); ell_src: (E,) int32 slot
// sources; items: (n_items, 4) int32 warp items; n_rows: the slices' rows
// in all; rank: (n,) int32; tail_ell: (n, tdc) int32; tail_src/tail_val:
// (tail_cap,) int32 / bool; scratch fw: (n, W) uint32, act: (ceil(n / 32),)
// uint32, roww: (n_rows, W) uint32, W = ceil(B / 32); out: (B, n) bool.
// B <= 128 per call.
extern "C" int repro_csr_bool_step(
    const void* f, int B, int n, const int* ell_src, const void* items,
    int n_items, int n_rows, const int* rank, const int* tail_ell, int tdc,
    const int* tail_src, const void* tail_val, void* fw, void* act,
    void* roww, void* out, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (B > 128) return (int)cudaErrorInvalidValue;  // the wrapper splits B
  const uint8_t* pf = (const uint8_t*)f;
  const int4* it = (const int4*)items;
  const uint8_t* tv = (const uint8_t*)tail_val;
  unsigned *pw = (unsigned*)fw, *pa = (unsigned*)act, *pr = (unsigned*)roww;
  uint8_t* po = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((B + 31) / 32) {
    case 1:
      return k3_step<1>(pf, B, n, ell_src, it, n_items, n_rows, rank,
                        tail_ell, tdc, tail_src, tv, pw, pa, pr, po, s);
    case 2:
      return k3_step<2>(pf, B, n, ell_src, it, n_items, n_rows, rank,
                        tail_ell, tdc, tail_src, tv, pw, pa, pr, po, s);
    case 3:
      return k3_step<3>(pf, B, n, ell_src, it, n_items, n_rows, rank,
                        tail_ell, tdc, tail_src, tv, pw, pa, pr, po, s);
    default:
      return k3_step<4>(pf, B, n, ell_src, it, n_items, n_rows, rank,
                        tail_ell, tdc, tail_src, tv, pw, pa, pr, po, s);
  }
}

// K4 / K5 / K6.  f: (B, n) f32 frontier; ell_src/ell_val: (E,) int32 / f32
// slot sources and values; items: (n_items, 4) int32 warp items;
// row_piece: (rows + 1,) int32; rank: (n,) int32; tail_ell: (n, tdc)
// int32; tail_src/tail_val: (tail_cap,) int32 / f32; scratch fT: (n, B)
// f32, act: (ceil(n / 32),) uint32, part: (pieces, B) f32, live: (pieces,)
// uint8; out: (B, n) f32.  B <= 128 per call.
extern "C" int repro_csr_minplus_step(
    const void* f, int B, int n, const int* ell_src, const void* ell_val,
    const void* items, int n_items, const int* row_piece, const int* rank,
    const int* tail_ell, int tdc, const int* tail_src, const void* tail_val,
    void* fT, void* act, void* part, void* live, void* out, void* stream) {
  return ell_step_dispatch<MinPlusOp>(
      f, B, n, ell_src, ell_val, items, n_items, row_piece, rank, tail_ell,
      tdc, tail_src, tail_val, fT, act, part, live, out, stream);
}

extern "C" int repro_csr_plustimes_step(
    const void* f, int B, int n, const int* ell_src, const void* ell_val,
    const void* items, int n_items, const int* row_piece, const int* rank,
    const int* tail_ell, int tdc, const int* tail_src, const void* tail_val,
    void* fT, void* act, void* part, void* live, void* out, void* stream) {
  return ell_step_dispatch<PlusTimesOp>(
      f, B, n, ell_src, ell_val, items, n_items, row_piece, rank, tail_ell,
      tdc, tail_src, tail_val, fT, act, part, live, out, stream);
}

extern "C" int repro_csr_maxplus_step(
    const void* f, int B, int n, const int* ell_src, const void* ell_val,
    const void* items, int n_items, const int* row_piece, const int* rank,
    const int* tail_ell, int tdc, const int* tail_src, const void* tail_val,
    void* fT, void* act, void* part, void* live, void* out, void* stream) {
  return ell_step_dispatch<MaxPlusOp>(
      f, B, n, ell_src, ell_val, items, n_items, row_piece, rank, tail_ell,
      tdc, tail_src, tail_val, fT, act, part, live, out, stream);
}

// K7.  f: (B, n) f32 frontier; tsrc/tdst/tval: (A,) int32 / int32 / f32
// planned arcs in destination order; units: (n_units, 4) int32 work units
// (tile, first arc, end arc, flags); bn: the plan's tile width (a power of
// two); tail_ell: (n, tdc) int32; tail_src/tail_val: (tail_cap,) int32 /
// f32; scratch fT: (n, B) f32, act: (ceil(n / 32),) uint32; out: (B, n)
// f32.  B <= 128 per call.
extern "C" int repro_csr_minplus_tiled_step(
    const void* f, int B, int n, const int* tsrc, const int* tdst,
    const void* tval, const void* units, int n_units, int bn,
    const int* tail_ell, int tdc, const int* tail_src, const void* tail_val,
    void* fT, void* act, void* out, void* stream) {
  if (B <= 0 || n <= 0 || n_units <= 0) return 0;
  if (B > 128 || bn <= 0 || (bn & (bn - 1)) != 0)
    return (int)cudaErrorInvalidValue;  // the wrapper splits B
  cudaStream_t s = (cudaStream_t)stream;
  const float* pf = (const float*)f;
  float* pT = (float*)fT;
  unsigned* pa = (unsigned*)act;
  const unsigned tblocks = (unsigned)((n + 31) / 32);
  if (B <= 32)
    ell_transpose_kernel<MinPlusOp, 1><<<tblocks, dim3(32, 8), 0, s>>>(pf, B, n, pT, pa);
  else if (B <= 64)
    ell_transpose_kernel<MinPlusOp, 2><<<tblocks, dim3(32, 8), 0, s>>>(pf, B, n, pT, pa);
  else
    ell_transpose_kernel<MinPlusOp, 4><<<tblocks, dim3(32, 8), 0, s>>>(pf, B, n, pT, pa);
  REPRO_LAUNCH_CHECK();
  tile_fill_kernel<<<(unsigned)n_units, TILED_THREADS, 0, s>>>(
      (const int4*)units, bn, n, B, (float*)out);
  REPRO_LAUNCH_CHECK();
  const size_t smem = (size_t)TILED_ROWS * (bn + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        minplus_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)n_units, (unsigned)((B + TILED_ROWS - 1) / TILED_ROWS));
  minplus_tile_kernel<<<grid, TILED_THREADS, smem, s>>>(
      (const int4*)units, bn, n, tsrc, tdst, (const float*)tval, tail_ell,
      tdc, tail_src, (const float*)tail_val, pa, pT, B, (float*)out);
  REPRO_LAUNCH_CHECK();
  return 0;
}
