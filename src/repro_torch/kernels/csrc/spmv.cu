// K3 / K4 — one CSR frontier step on the bool and min-plus carriers:
//
//   out[b, v] = ⊕_{p in segments(v)} frontier[b, src_idx[p]] ⊗ edge_val[p]
//
// with (⊕, ⊗) = (OR, AND) for K3 and (min, +) for K4, the segments of v
// being its row of the sliced-ELL map (ell_slices / ell_rank) plus its row
// of the COO tail's single-width map (tail_ell / tail_src / tail_val).
//
// Replaces: src/repro/kernels/spmv.py, `csr_bool_spmv` (K3) and
// `csr_minplus_spmv` (K4), as driven by ops._csr_bool_step /
// ops._csr_minplus_step (spine + tail).  The TPU kernels keep the whole
// (B, n) frontier resident in VMEM and scatter by destination through a
// one-hot MXU product (bool) or a masked broadcast-min over column tiles
// (min-plus).  Neither carries over: at B = 32 and n = 2^20 one frontier is
// 128 MB of f32, and a one-hot scatter is O(|E|·n).
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
// OR and min do not depend on order, so the result is bit-identical to the
// plain PyTorch step and to the JAX one.
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
