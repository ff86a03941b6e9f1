// K4 / K6 — one CSR frontier step on the min-plus and max-plus carriers:
//
//   out[b, v] = ⊕_{p in segments(v)} frontier[b, src_idx[p]] ⊗ edge_val[p]
//
// with (⊕, ⊗) = (min, +) for K4 and (max, +) for K6, the segments of v
// being its row of the sliced-ELL map (ell_slices / ell_rank) plus its row
// of the COO tail's single-width map (tail_ell / tail_src / tail_val).
//
// Replaces: src/repro/kernels/spmv.py, `csr_minplus_spmv` (K4) and
// `csr_maxplus_spmv` (K6), as driven by ops._csr_<carrier>_step (spine +
// tail).  The TPU kernels keep the whole (B, n) frontier resident in VMEM
// and reduce by destination through a masked broadcast-min/max over column
// tiles.  That does not carry over: at B = 32 and n = 2^20 one frontier is
// 128 MB of f32.
//
// What bounds it on the H100: device memory.  Per step the kernel reads the
// frontier once, each live arc's position, source and value once, and
// gathers one frontier row segment per live arc; the arithmetic (one ⊗ and
// one ⊕ per arc and batch row) is negligible next to the gathers.
//
// Design — a pull over the CSR's own segment map, no atomics:
//  1. transpose the (B, n) frontier to (n, B), so the B values of one source
//     vertex are one contiguous run: a warp's lanes (one per batch row)
//     gather them in a single coalesced access;
//  2. per ELL slice, one warp per (row, segment): lanes load 32 positions'
//     (src, val) at once, sentinel positions (val = ⊕-zero) are skipped by
//     a warp ballot, and the live ones are broadcast with shuffles and
//     gathered eight at a time (eight loads in flight per lane).  Rows wider
//     than SEG positions (the power-law hubs: one slice of 19 rows holds
//     in-degrees up to ~184k) are cut into SEG-position segments, one warp
//     each, and a second pass ⊕-reduces the per-segment partials — so a hub
//     is spread over hundreds of warps instead of serializing one thread;
//  3. per vertex, read its slice row's result through ell_rank (dead
//     vertices share the all-sentinel row 0), fold in the COO tail the same
//     way, and write out[b, v] through a shared-memory tile so the (B, n)
//     stores are coalesced.
// Min and max do not depend on order, so K4 and K6 are bit-identical to the
// plain PyTorch step and to the JAX one.
//
// K3 (bool) and K5 (plus-times) have kernels of their own below, over the
// CSR's ELL-ordered sources (core.sparse._ell_order); K7 closes the file.
#include "common.cuh"

namespace {

constexpr int PULL_THREADS = 256;   // 8 warps per block
constexpr int GATHER_VERTS = 32;    // vertices per gather block
constexpr int UNROLL = 8;           // gathers in flight per lane

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

// ⊕-fold the positions idx[0 .. len) into acc (lane owns batch rows
// lane + 32 q).  All 32 lanes of the warp must call it together.
template <class Op, int NB>
__device__ __forceinline__ void pull_positions(
    const int* __restrict__ idx, int len, const int* __restrict__ src,
    const typename Op::T* __restrict__ val, const typename Op::T* __restrict__ fT,
    int B, int lane, typename Op::T (&acc)[NB]) {
  using T = typename Op::T;
  for (int c0 = 0; c0 < len; c0 += 32) {
    const int c = c0 + lane;
    int s = 0;
    T w = Op::zero();
    if (c < len) {
      const int p = __ldg(idx + c);
      s = __ldg(src + p);
      w = val[p];
    }
    const unsigned live = __ballot_sync(REPRO_FULL_MASK, Op::live(w));
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += UNROLL) {
      if (((live >> j0) & ((1u << UNROLL) - 1u)) == 0u) continue;  // uniform
      T v[UNROLL][NB];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int sj = __shfl_sync(REPRO_FULL_MASK, s, j0 + u);
        const T wj = repro_shfl(w, j0 + u);
        const bool lv = (live >> (j0 + u)) & 1u;
        const T* frow = fT + (size_t)sj * B;
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          const int b = lane + 32 * q;
          v[u][q] = (lv && b < B) ? Op::combine(frow[b], wj) : Op::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int q = 0; q < NB; ++q) acc[q] = Op::reduce(acc[q], v[u][q]);
    }
  }
}

// (rows, cols) -> (cols, rows), 32 x 32 shared-memory tiles.
template <class T>
__global__ void transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                                 int rows, int cols) {
  __shared__ T tile[32][33];
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    const int y = y0 + j;
    if (x < cols && y < rows) tile[j][threadIdx.x] = in[(size_t)y * cols + x];
  }
  __syncthreads();
  const int ox = y0 + threadIdx.x;
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    const int oy = blockIdx.x * 32 + j;
    if (ox < rows && oy < cols) out[(size_t)oy * rows + ox] = tile[threadIdx.x][j];
  }
}

// One warp per (slice row, segment): dst[(row * nseg + sg) * B + b].
template <class Op, int NB>
__global__ void __launch_bounds__(PULL_THREADS)
slice_pull_kernel(const int* __restrict__ ell, int rows, int cap, int seg,
                  int nseg, const int* __restrict__ src,
                  const typename Op::T* __restrict__ val,
                  const typename Op::T* __restrict__ fT, int B,
                  typename Op::T* __restrict__ dst) {
  using T = typename Op::T;
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= rows * nseg) return;  // uniform across the warp
  const int row = warp / nseg, sg = warp % nseg;
  const int first = sg * seg;
  const int len = min(seg, cap - first);
  T acc[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q) acc[q] = Op::zero();
  pull_positions<Op, NB>(ell + (size_t)row * cap + first, len, src, val, fT, B,
                         lane, acc);
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int b = lane + 32 * q;
    if (b < B) dst[(size_t)warp * B + b] = acc[q];
  }
}

// One warp per row: dst[row * B + b] = ⊕_sg part[(row * nseg + sg) * B + b].
template <class Op, int NB>
__global__ void __launch_bounds__(PULL_THREADS)
segment_reduce_kernel(const typename Op::T* __restrict__ part, int rows,
                      int nseg, int B, typename Op::T* __restrict__ dst) {
  using T = typename Op::T;
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int b = lane + 32 * q;
    if (b >= B) continue;
    T acc = Op::zero();
    for (int sg = 0; sg < nseg; ++sg)
      acc = Op::reduce(acc, part[((size_t)row * nseg + sg) * B + b]);
    dst[(size_t)row * B + b] = acc;
  }
}

// Per vertex: its slice row's result (through ell_rank) ⊕ its COO tail row,
// staged in shared memory and written to out (B, n) in coalesced runs.
template <class Op, int NB>
__global__ void __launch_bounds__(PULL_THREADS)
gather_tail_kernel(const typename Op::T* __restrict__ cat,
                   const int* __restrict__ rank,
                   const int* __restrict__ tail_ell, int tdc,
                   const int* __restrict__ tail_src,
                   const typename Op::T* __restrict__ tail_val,
                   const typename Op::T* __restrict__ fT, int B, int n,
                   typename Op::T* __restrict__ out) {
  using T = typename Op::T;
  __shared__ T tile[GATHER_VERTS][32 * NB + 1];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int v0 = blockIdx.x * GATHER_VERTS;
  for (int i = wid; i < GATHER_VERTS; i += nwarps) {
    const int v = v0 + i;
    if (v >= n) break;  // uniform across the warp
    const T* crow = cat + (size_t)__ldg(rank + v) * B;
    T acc[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int b = lane + 32 * q;
      acc[q] = b < B ? crow[b] : Op::zero();
    }
    pull_positions<Op, NB>(tail_ell + (size_t)v * tdc, tdc, tail_src,
                           tail_val, fT, B, lane, acc);
#pragma unroll
    for (int q = 0; q < NB; ++q) tile[i][lane + 32 * q] = acc[q];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < B * GATHER_VERTS; k += blockDim.x) {
    const int b = k / GATHER_VERTS, i = k % GATHER_VERTS;
    const int v = v0 + i;
    if (v < n) out[(size_t)b * n + v] = tile[i][b];
  }
}

template <class T>
int transpose(const T* in, T* out, int rows, int cols, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32);
  transpose_kernel<T><<<grid, block, 0, s>>>(in, out, rows, cols);
  REPRO_LAUNCH_CHECK();
  return 0;
}

template <class Op, int NB>
int csr_step(const typename Op::T* f, int B, int n, const int* src,
             const typename Op::T* val, int n_slices, const int* const* ells,
             const int* rows, const int* caps, int seg, const int* rank,
             const int* tail_ell, int tdc, const int* tail_src,
             const typename Op::T* tail_val, typename Op::T* fT,
             typename Op::T* cat, typename Op::T* part,
             typename Op::T* out, cudaStream_t s) {
  const int warps_per_block = PULL_THREADS / 32;
  int rc = transpose<typename Op::T>(f, fT, B, n, s);
  if (rc) return rc;
  size_t off = 0;  // row offset of this slice in the concatenated output
  for (int i = 0; i < n_slices; ++i) {
    const int R = rows[i], C = caps[i];
    const int sseg = C < seg ? C : seg;
    const int nseg = (C + sseg - 1) / sseg;
    typename Op::T* dst = nseg == 1 ? cat + off * B : part;
    const long long warps = (long long)R * nseg;
    const unsigned blocks = (unsigned)((warps + warps_per_block - 1) / warps_per_block);
    slice_pull_kernel<Op, NB><<<blocks, PULL_THREADS, 0, s>>>(
        ells[i], R, C, sseg, nseg, src, val, fT, B, dst);
    REPRO_LAUNCH_CHECK();
    if (nseg > 1) {
      const unsigned rblocks = (unsigned)((R + warps_per_block - 1) / warps_per_block);
      segment_reduce_kernel<Op, NB><<<rblocks, PULL_THREADS, 0, s>>>(
          part, R, nseg, B, cat + off * B);
      REPRO_LAUNCH_CHECK();
    }
    off += (size_t)R;
  }
  const unsigned gblocks = (unsigned)((n + GATHER_VERTS - 1) / GATHER_VERTS);
  gather_tail_kernel<Op, NB><<<gblocks, PULL_THREADS, 0, s>>>(
      cat, rank, tail_ell, tdc, tail_src, tail_val, fT, B, n, out);
  REPRO_LAUNCH_CHECK();
  return 0;
}

template <class Op>
int csr_step_dispatch(const void* f, int B, int n, const int* src,
                      const void* val, int n_slices, const void* const* ells,
                      const int* rows, const int* caps, int seg,
                      const int* rank, const int* tail_ell, int tdc,
                      const int* tail_src, const void* tail_val, void* fT,
                      void* cat, void* part, void* out, void* stream) {
  using T = typename Op::T;
  if (B <= 0 || n <= 0) return 0;
  if (B > 128) return (int)cudaErrorInvalidValue;  // the wrapper splits B
  const T* pf = (const T*)f;
  const T* pv = (const T*)val;
  const T* ptv = (const T*)tail_val;
  const int* const* pe = (const int* const*)ells;
  T *pT = (T*)fT, *pc = (T*)cat, *pp = (T*)part, *po = (T*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 32)
    return csr_step<Op, 1>(pf, B, n, src, pv, n_slices, pe, rows, caps, seg,
                           rank, tail_ell, tdc, tail_src, ptv, pT, pc, pp, po, s);
  if (B <= 64)
    return csr_step<Op, 2>(pf, B, n, src, pv, n_slices, pe, rows, caps, seg,
                           rank, tail_ell, tdc, tail_src, ptv, pT, pc, pp, po, s);
  return csr_step<Op, 4>(pf, B, n, src, pv, n_slices, pe, rows, caps, seg,
                         rank, tail_ell, tdc, tail_src, ptv, pT, pc, pp, po, s);
}


// ---------------------------------------------------------------------------
// K3 / K5 — the bool and plus-times steps over ELL-ordered sources.
//
//   K3: out[b, v] = OR_{p in segments(v)} frontier[b, src_idx[p]] AND edge_val[p]
//   K5: out[b, v] = Σ_{p in segments(v)} frontier[b, src_idx[p]] × edge_val[p]
//
// Replaces: src/repro/kernels/spmv.py, `csr_bool_spmv` (K3) and
// `csr_plustimes_spmv` (K5), as driven by ops._csr_<carrier>_step (spine +
// tail).  The TPU kernels gather each arc chunk's frontier values, skip a
// chunk whose sources are all inactive (`pl.when(act_ref[c] != 0)`), and
// scatter by destination through a one-hot MXU product; a one-hot scatter
// is O(|E|·n) here, so the port pulls by destination instead.
//
// What bounds them on the H100: device memory.  The least work reads the
// frontier once, the live sources' arcs once and writes the output once;
// at the batch layer's first step almost no source is active.
//
// Design.  Both read the CSR's derived, ELL-ordered arrays
// (core.sparse._ell_order, built once per CSR on the card): ell_src[k] is
// the source of slot k of the slices laid end to end (-1 for a sentinel),
// ell_val[k] its value (K5 only), and a work list of warp items over
// *pieces*: a row of capacity <= 16 is one piece and 32 / cap such rows
// share an item (one 32-slot load); a wider row is cut into pieces of up to
// ELL_SEG slots, ending at its last live slot, one item each, so the hub
// rungs spread over every SM.  All slices are one launch.  So a warp's 32
// slots cost two coalesced loads (through the arc positions they would
// cost one coalesced and two scattered), and no slot past a row's last
// arc is read.
//
// K5 (lanes = batch rows, NB = ceil(B / 32) values a lane):
//  1. k5_transpose_kernel reads the (B, n) frontier once, writes the (n, B)
//     rows of the *active* sources only (a value nonzero in some batch row)
//     and a bitmask of them (n / 8 bytes, cached in L1);
//  2. k5_pull_kernel, one warp per item: each lane loads a slot's source
//     and its activity bit, the warp ballots "live and active", and only
//     those arcs are gathered (one coalesced B-value row each, eight in
//     flight).  Skipping is exact for finite weights: an inactive source's
//     values are ±0 in every row, so its arc adds 0 × w = ±0 to a sum that
//     starts at +0.0 and so cannot change it.  Each piece's sum goes to
//     part[piece]; a per-piece flag says whether any arc was live, so a
//     dead piece writes nothing else;
//  3. k5_gather_kernel, one warp per 32 vertices: lanes (one a vertex) find
//     the vertices with a live piece or an active COO-tail arc; for each of
//     those the warp (lanes = batch rows) folds its row's live pieces and
//     then its tail arcs, and every vertex's B values leave through a
//     shared-memory tile as coalesced (B, n) stores.
// The order of K5's sum is fixed by the data, never by scheduling: within a
// row, the positions of each piece in slot order from +0.0; then the
// pieces in order from +0.0; then the COO tail's positions in order.  No
// atomics, so repeated runs give identical bits
// (spmv.plustimes_in_kernel_order is the same order in PyTorch).  The
// plain step sums in torch.sum's order instead, so K5 equals it (and the
// JAX steps) exactly while every partial sum is an integer below 2^24 —
// f32 adds integers exactly there, whatever the order.  The service's EDB
// is integral and path counts are integers, so that is the contract (the
// JAX package's plus-times kernel states the same one); non-integer sums
// may differ from the plain step in the last bits.
//
// K3 (lanes = slots, W = ceil(B / 32) words a vertex):
//  1. k3_pack_kernel packs the (B, n) bool frontier into (n, W) uint32
//     words, bit b % 32 of word b / 32 (4 MiB a word at n = 2^20, resident
//     in L2), plus the same activity bitmask as K5;
//  2. k3_pull_kernel, one warp per item: each lane takes one slot and, if
//     its source is active, ORs in the source's W words; the lanes of one
//     row OR-reduce by __shfl_xor_sync (a capacity below 32 puts 32 / cap
//     rows in a warp), and the row's first lane ORs the result into its
//     row's words (an atomicOr where a hub's pieces meet);
//  3. k3_unpack_kernel, 256 vertices a block: each vertex's row words
//     (through ell_rank), its COO tail's words ORed in shared memory, then
//     unpacked into the (B, n) bool output in coalesced runs.
// OR is order-free, so K3 is bit-identical to the plain step and to JAX
// for every B.  Both take B <= 128; the wrapper splits larger batches.
constexpr int K35_THREADS = 256;  // 8 warps a block
constexpr int K35_UNROLL = 8;     // gathers in flight per lane

// Is source s (-1: a sentinel slot) active: nonzero in some batch row?
__device__ __forceinline__ bool k35_active(const unsigned* __restrict__ act,
                                           int s) {
  return s >= 0 && ((__ldg(act + (s >> 5)) >> (s & 31)) & 1u);
}

// acc[q] += fT[s_j][b] × w_j for the set bits j of `live` in ascending
// order, (s_j, w_j) being lane j's (s, w); lane owns batch rows lane + 32q.
// `live` is warp-uniform and all 32 lanes call.
template <int NB>
__device__ __forceinline__ void k5_add_arcs(unsigned live, int s, float w,
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
        v[u][q] = ok[u] && b < B ? __ldg(row + b) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < K35_UNROLL; ++u)
      if (ok[u])
#pragma unroll
        for (int q = 0; q < NB; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(v[u][q], wj[u]));
  }
}

// acc[q] += part[k0 + j][b] for the set bits j of `live` in ascending order.
template <int NB>
__device__ __forceinline__ void k5_add_pieces(unsigned live, int k0,
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
        v[u][q] = ok[u] && b < B ? __ldg(row + b) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < K35_UNROLL; ++u)
      if (ok[u])
#pragma unroll
        for (int q = 0; q < NB; ++q) acc[q] = __fadd_rn(acc[q], v[u][q]);
  }
}

// Block (32, 8), 32 vertices: fT rows of the active vertices, and their
// activity bits (one word a block).
template <int NB>
__global__ void __launch_bounds__(K35_THREADS)
k5_transpose_kernel(const float* __restrict__ f, int B, int n,
                    float* __restrict__ fT, unsigned* __restrict__ act) {
  __shared__ float tile[32 * NB][33];
  __shared__ unsigned mask;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int v0 = blockIdx.x * 32, x = v0 + tx;
  if (tx == 0 && ty == 0) mask = 0u;
  __syncthreads();
  bool any = false;
  for (int b = ty; b < B; b += blockDim.y) {
    const float val = x < n ? f[(size_t)b * n + x] : 0.0f;
    tile[b][tx] = val;
    any |= val != 0.0f;
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
template <int NB>
__global__ void __launch_bounds__(K35_THREADS)
k5_pull_kernel(const int4* __restrict__ items, int n_items,
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
    float w = 0.0f;
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
      for (int q = 0; q < NB; ++q) acc[q] = 0.0f;
      k5_add_arcs<NB>(bits, s, w, fT, B, lane, acc);
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int b = lane + 32 * q;
        if (b < B) part[(size_t)(k0 + t) * B + b] = acc[q];
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < NB; ++q) acc[q] = 0.0f;
  unsigned any = 0u;
  for (int c0 = lo; c0 < lo + len; c0 += 32) {
    const int c = c0 + lane;
    int s = -1;
    float w = 0.0f;
    if (c < lo + len) s = __ldcs(ell_src + c);
    const bool a = k35_active(act, s);
    if (a) w = __ldcs(ell_val + c);
    const unsigned live = __ballot_sync(REPRO_FULL_MASK, a);
    any |= live;
    k5_add_arcs<NB>(live, s, w, fT, B, lane, acc);
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
template <int NB>
__global__ void __launch_bounds__(K35_THREADS)
k5_gather_kernel(const float* __restrict__ part,
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
    if (__ldg(tail_val + p) != 0.0f && k35_active(act, __ldg(tail_src + p)))
      tail_need |= 1u << (i / tdc);
  }
  tail_need = __reduce_or_sync(REPRO_FULL_MASK, tail_need);
  need |= ((tail_need >> lane) & 1u) != 0u;
  float(*my)[32 * NB + 1] = tile[wid];
  for (int b = 0; b < B; ++b) my[lane][b] = 0.0f;
  __syncwarp();
  unsigned todo = __ballot_sync(REPRO_FULL_MASK, need);
  while (todo) {  // uniform
    const int j = __ffs(todo) - 1;
    todo &= todo - 1u;
    const int pl = __shfl_sync(REPRO_FULL_MASK, plo, j);
    const int ph = __shfl_sync(REPRO_FULL_MASK, phi, j);
    float acc[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) acc[q] = 0.0f;
    for (int k0 = pl; k0 < ph; k0 += 32) {  // the row's pieces, in order
      const bool lv = k0 + lane < ph && __ldg(live_piece + k0 + lane);
      k5_add_pieces<NB>(__ballot_sync(REPRO_FULL_MASK, lv), k0, part, B,
                        lane, acc);
    }
    const int* tl = tail_ell + (size_t)(v0 + j) * tdc;
    for (int c0 = 0; c0 < tdc; c0 += 32) {  // then its tail, in order
      int s = -1;
      float w = 0.0f;
      if (c0 + lane < tdc) {
        const int p = __ldg(tl + c0 + lane);
        w = __ldg(tail_val + p);
        if (w != 0.0f) s = __ldg(tail_src + p);
      }
      const bool a = k35_active(act, s);
      k5_add_arcs<NB>(__ballot_sync(REPRO_FULL_MASK, a), s, w, fT, B, lane,
                      acc);
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) my[j][lane + 32 * q] = acc[q];
  }
  __syncwarp();
  if (lane < nv)
    for (int b = 0; b < B; ++b) out[(size_t)b * n + v] = my[lane][b];
}

template <int NB>
int k5_step(const float* f, int B, int n, const int* ell_src,
            const float* ell_val, const int4* items, int n_items,
            const int* row_piece, const int* rank, const int* tail_ell,
            int tdc, const int* tail_src, const float* tail_val, float* fT,
            unsigned* act, float* part, uint8_t* live_piece, float* out,
            cudaStream_t s) {
  k5_transpose_kernel<NB><<<(n + 31) / 32, dim3(32, 8), 0, s>>>(f, B, n, fT,
                                                                 act);
  REPRO_LAUNCH_CHECK();
  if (n_items > 0) {
    const unsigned blocks = (unsigned)((n_items + 7) / 8);
    k5_pull_kernel<NB><<<blocks, K35_THREADS, 0, s>>>(
        items, n_items, ell_src, ell_val, act, fT, B, part, live_piece);
    REPRO_LAUNCH_CHECK();
  }
  constexpr int GW = 8 / NB;
  const unsigned gblocks = (unsigned)((n + 32 * GW - 1) / (32 * GW));
  k5_gather_kernel<NB><<<gblocks, 32 * GW, 0, s>>>(
      part, live_piece, row_piece, rank, tail_ell, tdc, tail_src, tail_val,
      act, fT, B, n, out);
  REPRO_LAUNCH_CHECK();
  return 0;
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
//   out[b, v] = min( min_{items (t, c) with v in tile t} min_{p in chunk c,
//                          col_idx[p] = v} frontier[b, src[p]] + val[p],
//                    its COO-tail row as in K4 )
//
// Replaces: src/repro/kernels/spmv.py, `csr_minplus_spmv_tiled`, as driven
// by ops._csr_minplus_step on a CSR that carries a plan (plus the untiled
// tail pass JAX launches after it: here the tail folds into the same
// step).  The TPU kernel walks the (tile, chunk) worklist in order on one
// core, revisiting each (B, bn) output block in VMEM and computing a
// (B, chunk, bn) masked broadcast-min per item.  On Hopper blocks run in
// no order and nothing carries between them, so:
//
//  * Work units, not grid steps: the host cuts each tile's items into units
//    of at most PLAN_UNIT items (core.sparse._plan_units), one CTA per
//    (unit, 32 batch rows).  Pad items (repeats of the last live item) lie
//    past the last unit and are never read.  A power-law graph sends a hit
//    from almost every arc chunk to its first tile; units spread that tile
//    over many SMs instead of one.
//  * A (32, bn) f32 accumulator in shared memory, starting at +inf (row
//    pitch bn + 1, so the 32 lanes of a warp, one batch row each, hit 32
//    banks).  A warp takes an item, loads its chunk's destinations 32 at a
//    time, keeps the arcs whose destination lies in the tile and whose
//    value is live (a ballot), and for each one gathers the 32 rows'
//    frontier values in one coalesced access from the transposed frontier
//    (n, B), as K4 does.  Warps of one CTA can meet at one (row, column),
//    so the min goes through an order-free atomic min on the f32 bits
//    (skipped when it would not lower the value).  Min is order-free and
//    idempotent, so the result is bit-identical to the plain step.
//  * The tile's first unit also folds the COO tail over tail_ell for the
//    tile's columns (one warp per column), so a tuned step is one call.
//  * A unit that covers its whole tile stores its block; the units of a
//    split tile meet in device memory through the same atomic min, on an
//    output the wrapper fills with +inf.  Columns at or past n (the plan
//    covers padded_width(n, bn) columns; the frontier is n wide) are
//    masked, and tiles starting past n exit at once.
//
// What bounds it on the H100: device memory.  The least work reads the
// frontier once, each live arc and plan entry once, and writes the output
// once.  The plan is built for the TPU's tiles, so on a graph whose arcs
// are in (src, dst) order each arc chunk is read once per tile it hits
// (for the power-law smoke graph about 14M items of 32 arcs for 16M arcs):
// that re-reading, not the bound, sets its time.  A plan for Hopper's own
// tile shape (arcs reordered by destination tile) is later work.
constexpr int TILED_THREADS = 256;  // 8 warps per unit
constexpr int TILED_ROWS = 32;      // batch rows per CTA (one per lane)

// min on f32 through the integer atomics: non-negative floats order like
// their int bits, negative ones reverse like their unsigned bits.
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (v >= 0.0f)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

__global__ void __launch_bounds__(TILED_THREADS)
minplus_tiled_kernel(const int* __restrict__ plan_tile,
                     const int* __restrict__ plan_chunk,
                     const int* __restrict__ plan_first,
                     const int* __restrict__ plan_unit, int n_units,
                     int chunk, int bn, int n,
                     const int* __restrict__ col_idx,
                     const int* __restrict__ src,
                     const float* __restrict__ val,
                     const int* __restrict__ tail_ell, int tdc,
                     const int* __restrict__ tail_src,
                     const float* __restrict__ tail_val,
                     const float* __restrict__ fT, int B,
                     float* __restrict__ out) {
  extern __shared__ float acc[];  // TILED_ROWS x (bn + 1)
  const int u = blockIdx.x;
  const int lo = plan_unit[u], hi = plan_unit[u + 1];
  const int tile = plan_tile[lo];
  const int col0 = tile * bn;
  if (col0 >= n) return;  // a pad tile of the plan's width: uniform
  const int pitch = bn + 1;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = blockIdx.y * TILED_ROWS + lane;
  const bool row_ok = b < B;
  float* my = acc + lane * pitch;
  for (int k = threadIdx.x; k < TILED_ROWS * pitch; k += blockDim.x)
    acc[k] = INFINITY;
  __syncthreads();

  for (int it = lo + wid; it < hi; it += nwarps) {
    const long long base = (long long)__ldg(plan_chunk + it) * chunk;
    for (int c0 = 0; c0 < chunk; c0 += 32) {
      int s = 0, col = 0;
      float w = INFINITY;
      if (c0 + lane < chunk) {
        const long long p = base + c0 + lane;
        col = __ldg(col_idx + p) - col0;
        if (col >= 0 && col < bn) {
          w = val[p];
          s = __ldg(src + p);
        }
      }
      unsigned live = __ballot_sync(REPRO_FULL_MASK, w != INFINITY);
      while (live) {  // uniform across the warp
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int sj = __shfl_sync(REPRO_FULL_MASK, s, j);
        const float wj = __shfl_sync(REPRO_FULL_MASK, w, j);
        const int cj = __shfl_sync(REPRO_FULL_MASK, col, j);
        if (row_ok) {
          const float v = __fadd_rn(fT[(size_t)sj * B + b], wj);
          if (v < my[cj]) atomic_min_f32(my + cj, v);
        }
      }
    }
  }
  const int ncols = min(bn, n - col0);
  if (plan_first[lo]) {  // the tile's first unit folds the COO tail
    __syncthreads();
    for (int c = wid; c < ncols; c += nwarps) {
      const int v = col0 + c;
      float a = my[c];
      for (int q0 = 0; q0 < tdc; q0 += 32) {
        int s = 0;
        float w = INFINITY;
        if (q0 + lane < tdc) {
          const int p = __ldg(tail_ell + (size_t)v * tdc + q0 + lane);
          s = __ldg(tail_src + p);
          w = tail_val[p];
        }
        unsigned live = __ballot_sync(REPRO_FULL_MASK, w != INFINITY);
        while (live) {
          const int j = __ffs(live) - 1;
          live &= live - 1;
          const int sj = __shfl_sync(REPRO_FULL_MASK, s, j);
          const float wj = __shfl_sync(REPRO_FULL_MASK, w, j);
          if (row_ok) a = fminf(a, __fadd_rn(fT[(size_t)sj * B + b], wj));
        }
      }
      my[c] = a;  // this warp owns column c now; lane owns its row
    }
  }
  __syncthreads();
  const int L = plan_unit[n_units];
  const bool whole = plan_first[lo] && (hi == L || plan_first[hi]);
  const int b0 = blockIdx.y * TILED_ROWS;
  for (int k = threadIdx.x; k < TILED_ROWS * bn; k += blockDim.x) {
    const int r = k / bn, c = k - r * bn;
    if (b0 + r >= B || c >= ncols) continue;
    const float a = acc[r * pitch + c];
    float* o = out + (size_t)(b0 + r) * n + col0 + c;
    if (whole)
      *o = a;
    else if (a != INFINITY)
      atomic_min_f32(o, a);
  }
}

}  // namespace

// K4 / K6.  f: (B, n) frontier; src/val: (cap,) packed arcs; ells[i]:
// (rows[i], caps[i]) int32 slice tables; rank: (n,) int32; tail_ell: (n,
// tdc) int32; tail_src/tail_val: (tail_cap,); scratch fT: (n, B), cat: (sum
// rows, B), part: (max rows·ceil(cap/seg) over wide slices, B); out: (B, n).
// B <= 128 per call.
extern "C" int repro_csr_minplus_step(
    const void* f, int B, int n, const int* src, const void* val,
    int n_slices, const void* const* ells, const int* rows, const int* caps,
    int seg, const int* rank, const int* tail_ell, int tdc,
    const int* tail_src, const void* tail_val, void* fT, void* cat,
    void* part, void* out, void* stream) {
  return csr_step_dispatch<MinPlusOp>(f, B, n, src, val, n_slices, ells, rows,
                                      caps, seg, rank, tail_ell, tdc, tail_src,
                                      tail_val, fT, cat, part, out, stream);
}

extern "C" int repro_csr_maxplus_step(
    const void* f, int B, int n, const int* src, const void* val,
    int n_slices, const void* const* ells, const int* rows, const int* caps,
    int seg, const int* rank, const int* tail_ell, int tdc,
    const int* tail_src, const void* tail_val, void* fT, void* cat,
    void* part, void* out, void* stream) {
  return csr_step_dispatch<MaxPlusOp>(f, B, n, src, val, n_slices, ells, rows,
                                      caps, seg, rank, tail_ell, tdc, tail_src,
                                      tail_val, fT, cat, part, out, stream);
}

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

// K5.  f: (B, n) f32 frontier; ell_src/ell_val: (E,) int32 / f32 slot
// sources and values; items: (n_items, 4) int32 warp items; row_piece:
// (rows + 1,) int32; rank: (n,) int32; tail_ell: (n, tdc) int32;
// tail_src/tail_val: (tail_cap,) int32 / f32; scratch fT: (n, B) f32, act:
// (ceil(n / 32),) uint32, part: (pieces, B) f32, live: (pieces,) uint8;
// out: (B, n) f32.  B <= 128 per call.
extern "C" int repro_csr_plustimes_step(
    const void* f, int B, int n, const int* ell_src, const void* ell_val,
    const void* items, int n_items, const int* row_piece, const int* rank,
    const int* tail_ell, int tdc, const int* tail_src, const void* tail_val,
    void* fT, void* act, void* part, void* live, void* out, void* stream) {
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
    return k5_step<1>(pf, B, n, ell_src, pv, it, n_items, row_piece, rank,
                      tail_ell, tdc, tail_src, tv, pT, pa, pp, pl, po, s);
  if (B <= 64)
    return k5_step<2>(pf, B, n, ell_src, pv, it, n_items, row_piece, rank,
                      tail_ell, tdc, tail_src, tv, pT, pa, pp, pl, po, s);
  return k5_step<4>(pf, B, n, ell_src, pv, it, n_items, row_piece, rank,
                    tail_ell, tdc, tail_src, tv, pT, pa, pp, pl, po, s);
}

// K7.  f: (B, n) frontier; col_idx/src/val: (cap,) packed arcs;
// plan_tile/plan_chunk/plan_first: (L,) worklist; plan_unit: (n_units + 1,)
// unit offsets into it (the last is the live item count); chunk and bn:
// the plan's block sizes (bn a power of two); tail_ell: (n, tdc) int32;
// tail_src/tail_val: (tail_cap,); scratch fT: (n, B); out: (B, n), filled
// with +inf by the caller.  Any B (32-row passes in the grid).
extern "C" int repro_csr_minplus_tiled_step(
    const void* f, int B, int n, const int* col_idx, const int* src,
    const void* val, const int* plan_tile, const int* plan_chunk,
    const int* plan_first, const int* plan_unit, int n_units, int chunk,
    int bn, const int* tail_ell, int tdc, const int* tail_src,
    const void* tail_val, void* fT, void* out, void* stream) {
  if (B <= 0 || n <= 0 || n_units <= 0) return 0;
  if (chunk <= 0 || bn <= 0 || (bn & (bn - 1)) != 0 ||
      (B + TILED_ROWS - 1) / TILED_ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = transpose<float>((const float*)f, (float*)fT, B, n, s);
  if (rc) return rc;
  const size_t smem = (size_t)TILED_ROWS * (bn + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        minplus_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)n_units, (unsigned)((B + TILED_ROWS - 1) / TILED_ROWS));
  minplus_tiled_kernel<<<grid, TILED_THREADS, smem, s>>>(
      plan_tile, plan_chunk, plan_first, plan_unit, n_units, chunk, bn, n,
      col_idx, src, (const float*)val, tail_ell, tdc, tail_src,
      (const float*)tail_val, (const float*)fT, B, (float*)out);
  REPRO_LAUNCH_CHECK();
  return 0;
}
