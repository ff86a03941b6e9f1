// K3 / K4 / K5 / K6 — one CSR frontier step per carrier:
//
//   out[b, v] = ⊕_{p in segments(v)} frontier[b, src_idx[p]] ⊗ edge_val[p]
//
// with (⊕, ⊗) = (OR, AND) for K3, (min, +) for K4, (+, ×) for K5 and
// (max, +) for K6, the segments of v being its row of the sliced-ELL map
// (ell_slices / ell_rank) plus its row of the COO tail's single-width map
// (tail_ell / tail_src / tail_val).
//
// Replaces: src/repro/kernels/spmv.py, `csr_bool_spmv` (K3),
// `csr_minplus_spmv` (K4), `csr_plustimes_spmv` (K5) and
// `csr_maxplus_spmv` (K6), as driven by ops._csr_<carrier>_step (spine +
// tail).  The TPU kernels keep the whole (B, n) frontier resident in VMEM
// and scatter by destination through a one-hot MXU product (bool; plus-times
// adds a per-chunk frontier-activity skip) or a masked broadcast-min/max
// over column tiles (min-plus, max-plus).  Neither carries over: at B = 32
// and n = 2^20 one frontier is 128 MB of f32, and a one-hot scatter is
// O(|E|·n).
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
// OR, min and max do not depend on order, so K3, K4 and K6 are bit-identical
// to the plain PyTorch step and to the JAX one.
//
// K5's sum does depend on order.  Its order is fixed (no atomics): positions
// in order within a segment, then segments in order (segment_reduce_kernel),
// then the COO tail's positions in order after the spine's result.  So
// repeated runs on the card give identical bits.  The plain step sums in
// torch.sum's order instead, so K5 equals it (and the JAX steps) exactly
// while every partial sum is an integer below 2^24 — f32 adds integers
// exactly there, whatever the order.  The service's EDB is integral, and
// path counts are integers, so that is the contract (the JAX package's
// plus-times kernel states the same one); non-integer sums may differ from
// the plain step in the last bits.
#include "common.cuh"

namespace {

constexpr int PULL_THREADS = 256;   // 8 warps per block
constexpr int GATHER_VERTS = 32;    // vertices per gather block
constexpr int UNROLL = 8;           // gathers in flight per lane

struct OrOp {
  using T = uint8_t;
  static __device__ __forceinline__ T zero() { return 0; }
  static __device__ __forceinline__ bool live(T w) { return w != 0; }
  static __device__ __forceinline__ T combine(T f, T w) { return (T)((f != 0) & (w != 0)); }
  static __device__ __forceinline__ T reduce(T a, T b) { return a | b; }
};

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

// f: (B, n) frontier; src/val: (cap,) packed arcs; ells[i]: (rows[i],
// caps[i]) int32 slice tables; rank: (n,) int32; tail_ell: (n, tdc) int32;
// tail_src/tail_val: (tail_cap,); scratch fT: (n, B), cat: (sum rows, B),
// part: (max rows·ceil(cap/seg) over wide slices, B); out: (B, n).
// B <= 128 per call.  Bool operands are 0/1 bytes (torch.bool).
extern "C" int repro_csr_bool_step(
    const void* f, int B, int n, const int* src, const void* val,
    int n_slices, const void* const* ells, const int* rows, const int* caps,
    int seg, const int* rank, const int* tail_ell, int tdc,
    const int* tail_src, const void* tail_val, void* fT, void* cat,
    void* part, void* out, void* stream) {
  return csr_step_dispatch<OrOp>(f, B, n, src, val, n_slices, ells, rows,
                                 caps, seg, rank, tail_ell, tdc, tail_src,
                                 tail_val, fT, cat, part, out, stream);
}

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

extern "C" int repro_csr_plustimes_step(
    const void* f, int B, int n, const int* src, const void* val,
    int n_slices, const void* const* ells, const int* rows, const int* caps,
    int seg, const int* rank, const int* tail_ell, int tdc,
    const int* tail_src, const void* tail_val, void* fT, void* cat,
    void* part, void* out, void* stream) {
  return csr_step_dispatch<PlusTimesOp>(f, B, n, src, val, n_slices, ells,
                                        rows, caps, seg, rank, tail_ell, tdc,
                                        tail_src, tail_val, fT, cat, part, out,
                                        stream);
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
