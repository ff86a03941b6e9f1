// K1 — boolean (∨,∧) frontier product: out[m, n] = OR_k a[m, k] & b[k, n].
//
// Replaces: src/repro/kernels/boolmm.py, `bool_matmul` / `_boolmm_kernel`
// (serving entry `bool_frontier_matmul`), the TPU kernel that runs the
// product on the MXU as an f32 matmul with a `> 0` epilogue over (8, 128)
// padded tiles.
//
// On Hopper the same product runs on the int8 tensor cores: torch.bool
// bytes are 0 or 1, exact u8 operands, and the count Σ_k a·b is at most
// K < 2^31, so an s32 accumulator and `> 0` give the same bits as the OR of
// ANDs (and as the plain version).
//
// What bounds it on the H100: at the serving shape (B = 128 frontier rows
// against a 10,112-vertex adjacency) the 102 MB of adjacency bytes, read
// once (0.031 ms at 3.35 TB/s); the 26 G u8 operations take 0.013 ms at
// 1,979 T ops/s.  At M = n (G10K) the 2.07 T operations take 1.05 ms.
// Neither is what holds it: a stage's steps (land, test, transpose, fence,
// multiply) run one after another between barriers, with two blocks an SM
// to overlap them.
//
// Design:
//  * a block of two warpgroups owns a 128 x 128 output tile, each
//    warpgroup 64 rows: one `wgmma.mma_async` m64n128k32 (u8 x u8 -> s32)
//    per 32 k, A and B both read from shared memory;
//  * 8-bit `wgmma` takes both operands K-major.  The frontier (M, K) is;
//    each 128-deep stage of it lands by 16-byte `cp.async` in the 128-byte
//    swizzle the descriptors name (16-byte chunk c of row r at c ^ (r % 8),
//    8-row groups 1024 bytes apart).  The adjacency (K, N) is N-major, and
//    no transposed copy of it is kept (it would go stale on `append`): each
//    stage of B lands as it lies (its chunks swizzled so that the next step
//    reads all 32 banks), then the block transposes it in shared memory
//    into the K-major swizzled layout, 4 x 4 bytes a lane with
//    `__byte_perm`, the lanes' stores ordered to hit all 32 banks;
//  * a ring of three stages: stages s + 1 and s + 2 load while stage s is
//    transposed and multiplied; two barriers a stage (the one after the
//    loads land also releases the slot loaded next); 113 KB of shared
//    memory, two blocks an SM;
//  * K is split over the grid (blockIdx.z; `boolmm.plan` picks the splits
//    so that the blocks fill the SMs: three at the serving shape, one at
//    M = n).  With more than one split the output is zeroed first and each
//    split stores a 1 where its count is positive: an OR, exact and
//    independent of order, with no scratch and no second pass;
//  * a stage whose A tile is all zero (converged or padded frontier rows)
//    is neither transposed nor multiplied, and a warpgroup whose 64 rows
//    lie past M (B <= 64) issues no products;
//  * ragged M, K and N are zero-filled in the loads and masked in the
//    stores, nothing is padded on the host.  When K or N is not a multiple
//    of 16, or a pointer is not 16-byte aligned, the stages load with
//    predicated byte loads instead (the plan's unaligned route), into the
//    same layout.
//
// Registers: 64 s32 accumulators a thread; `-Xptxas -v` (chip_smoke.py's
// build phase) reports 126 on either route, no spill.
#include "common.cuh"

namespace {

constexpr int BM = 128;             // output rows a block: two warpgroups
constexpr int BN = 128;             // output columns a block
constexpr int BK = 128;             // k bytes a stage: one swizzled row
constexpr int THREADS = 256;
constexpr int STAGES = 3;           // cp.async ring depth
constexpr int TILE = BM * BK;       // bytes of an A, raw B or K-major B tile
// A and raw B x STAGES, the K-major B, 1024 bytes to align: 113 KB, two
// blocks an SM (228 KB with the 1 KB the system keeps a block)
constexpr int SMEM = (2 * STAGES + 1) * TILE + 1024;
static_assert(BM == 128 && BN == 128 && BK == 128,
              "the transposition and the swizzles assume 128 x 128 bytes");

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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes become visible to the tensor cores
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A shared-memory matrix descriptor: 128-byte swizzle, 8-row groups 1024
// bytes apart, start at `p` (a 1024-byte-aligned tile plus a k offset
// inside its 128-byte rows)
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 s32, this warpgroup) += A (64 x 32 u8) · B (32 x 128 u8), both
// K-major in shared memory
__device__ __forceinline__ void wgmma_u8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
        "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// 16 bytes p[0 .. 16), those at or past `count` zero (byte loads: the
// unaligned route)
__device__ __forceinline__ uint4 gather16(const uint8_t* p, int count) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < count) w[e >> 2] |= (uint32_t)p[e] << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One stage: a[m0 .. m0+BM, k0 .. k0+BK) into a_s (K-major, swizzled: chunk
// c of row r at c ^ (r % 8)) and b[k0 .. k0+BK, n0 .. n0+BN) into b_s as it
// lies (chunk c of k row r at c ^ (2·((r / 4) % 4))); rows >= M, k >= k_hi
// and columns >= N are zero.
template <bool VEC>
__device__ __forceinline__ void load_stage(uint8_t* a_s, uint8_t* b_s,
                                           const uint8_t* __restrict__ a,
                                           const uint8_t* __restrict__ b,
                                           int M, int K, int N, int m0,
                                           int n0, int k0, int k_hi) {
  for (int i = threadIdx.x; i < BM * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const int gm = m0 + r, gk = k0 + 16 * c;
    uint8_t* dst = a_s + r * 128 + ((c ^ (r & 7)) << 4);
    const bool in = gm < M && gk < k_hi;
    const uint8_t* src = in ? a + (size_t)gm * K + gk : a;
    if (VEC)  // K % 16 == 0 and k_hi % 16 == 0: in or out whole
      cp_async16(dst, src, in ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(dst) = gather16(src, in ? k_hi - gk : 0);
  }
  for (int i = threadIdx.x; i < BK * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const int gk = k0 + r, gn = n0 + 16 * c;
    uint8_t* dst = b_s + r * 128 + ((c ^ (((r >> 2) & 3) << 1)) << 4);
    const bool in = gk < k_hi && gn < N;
    const uint8_t* src = in ? b + (size_t)gk * N + gn : b;
    if (VEC)  // N % 16 == 0
      cp_async16(dst, src, in ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(dst) = gather16(src, in ? N - gn : 0);
  }
}

// The landed B stage (k rows, n bytes) -> bt (n rows of 128 k bytes, in the
// descriptors' swizzle).  Warp w, pass j takes k [16·kc, 16·kc + 16) and
// n [32·ng, 32·ng + 32) (q = w + 8j, kc = q % 8, ng = q / 8); its lane
// (lq, ln) the 4 x 4 block at k 16·kc + 4·lq and n 32·ng + 4·ln.  Reads:
// the raw chunks' swizzle puts the 4 lq rows on 4 different 32-byte bank
// groups; stores: lane ln writes its 4 columns in an order rotated by
// ln / 2, so the warp's 32 stores of a step fall on 32 banks.
__device__ __forceinline__ void transpose_b(const uint8_t* raw, uint8_t* bt) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int lq = lane & 3, ln = lane >> 2, rot = ln >> 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = w + 8 * j;
    const int kc = q & 7, ng = q >> 3;
    const int k0 = 16 * kc + 4 * lq;
    const int chunk = (2 * ng + (ln >> 2)) ^ (2 * lq);  // (k0 / 4) % 4 == lq
    const uint8_t* src = raw + k0 * 128 + (chunk << 4) + 4 * (ln & 3);
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(src);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(src + 128);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(src + 256);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(src + 384);
    // w_i: k0 + i, columns n .. n + 3; o_c: column n + c, k0 .. k0 + 3
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
    const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
    const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
    const uint32_t o0 = __byte_perm(t0, t2, 0x5410);
    const uint32_t o1 = __byte_perm(t0, t2, 0x7632);
    const uint32_t o2 = __byte_perm(t1, t3, 0x5410);
    const uint32_t o3 = __byte_perm(t1, t3, 0x7632);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = (jj + rot) & 3;
      const uint32_t v = c == 0 ? o0 : c == 1 ? o1 : c == 2 ? o2 : o3;
      const int n = 32 * ng + 4 * ln + c;
      *reinterpret_cast<uint32_t*>(bt + n * 128 + ((kc ^ (n & 7)) << 4) +
                                   4 * lq) = v;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
bool_matmul_kernel(const uint8_t* __restrict__ a,
                   const uint8_t* __restrict__ b, uint8_t* __restrict__ out,
                   int M, int K, int N, int k_chunk) {
  extern __shared__ unsigned char smem_raw[];
  uint8_t* a_ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* b_ring = a_ring + STAGES * TILE;
  uint8_t* bt = a_ring + 2 * STAGES * TILE;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(K, k_lo + k_chunk);
  const int nst = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const bool wg_live = m0 + 64 * wg < M;  // uniform in the warpgroup

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst)
      load_stage<VEC>(a_ring + s * TILE, b_ring + s * TILE, a, b, M, K, N, m0,
                      n0, k_lo + s * BK, k_hi);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    const int slot = s % STAGES;
    const uint8_t* a_t = a_ring + slot * TILE;
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage s landed
    // An all-zero A tile: nothing to do this stage.  Each thread tests the
    // chunks it copied itself (visible to it after its wait); the barrier
    // then shows every thread's copies of stage s to all, and every thread
    // is past stage s - 1, whose slot is loaded next.
    uint32_t any = 0u;
    for (int i = tid; i < BM * 8; i += THREADS) {
      const int r = i >> 3, c = i & 7;
      const uint4 v = *reinterpret_cast<const uint4*>(
          a_t + r * 128 + ((c ^ (r & 7)) << 4));
      any |= v.x | v.y | v.z | v.w;
    }
    const int live = __syncthreads_or(any != 0u);
    {
      const int t = s + STAGES - 1;
      if (t < nst)
        load_stage<VEC>(a_ring + (t % STAGES) * TILE,
                        b_ring + (t % STAGES) * TILE, a, b, M, K, N, m0, n0,
                        k_lo + t * BK, k_hi);
      cp_async_commit();
    }
    if (!live) continue;

    transpose_b(b_ring + slot * TILE, bt);
    fence_async_shared();
    __syncthreads();
    if (wg_live) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_u8(acc, desc(a_t + wg * 64 * 128 + 32 * kk), desc(bt + 32 * kk));
      wgmma_commit();
      wgmma_wait0();  // before the next stage's barrier: bt is free then
    }
  }
  cp_async_wait<0>();
  if (!wg_live) return;

  // acc[4j + 2h + e]: row 16·(warp % 4) + lane / 4 + 8h of the warpgroup's
  // 64, column 8j + 2·(lane % 4) + e
  const bool ones_only = gridDim.z > 1;  // splits OR into a zeroed output
  const int row0 = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const uint8_t v0 = acc[4 * j + 2 * h] > 0;
      const uint8_t v1 = acc[4 * j + 2 * h + 1] > 0;
      uint8_t* p = out + (size_t)row * N + col;
      const bool pair = col + 1 < N;
      if (ones_only) {
        if (v0) p[0] = 1;
        if (v1 && pair) p[1] = 1;
      } else if (pair && (reinterpret_cast<uintptr_t>(p) & 1) == 0) {
        *reinterpret_cast<uint16_t*>(p) = (uint16_t)(v0 | (v1 << 8));
      } else {
        p[0] = v0;
        if (pair) p[1] = v1;
      }
    }
  }
}

template <bool VEC>
int launch(const uint8_t* a, const uint8_t* b, uint8_t* out, int M, int K,
           int N, int k_chunk, int splits, cudaStream_t s) {
  static bool attr = false;  // once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        bool_matmul_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  bool_matmul_kernel<VEC><<<grid, THREADS, SMEM, s>>>(a, b, out, M, K, N,
                                                      k_chunk);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

// a: (M, K) bool, b: (K, N) bool, out: (M, N) bool — all contiguous.
// k_chunk, splits and vec come from the wrapper's plan (kernels/boolmm.py).
extern "C" int repro_bool_matmul(const void* a, const void* b, void* out,
                                 int M, int K, int N, int k_chunk, int splits,
                                 int vec, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (splits > 1) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)M * N, s);
    if (e != cudaSuccess) return (int)e;
  }
  const uint8_t* pa = (const uint8_t*)a;
  const uint8_t* pb = (const uint8_t*)b;
  uint8_t* po = (uint8_t*)out;
  return vec ? launch<true>(pa, pb, po, M, K, N, k_chunk, splits, s)
             : launch<false>(pa, pb, po, M, K, N, k_chunk, splits, s);
}
