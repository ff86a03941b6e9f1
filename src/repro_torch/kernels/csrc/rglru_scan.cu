// K10 — the RG-LRU gated linear recurrence on the CUDA cores:
//
//   h[b, t, w] = a[b, t, w] * h[b, t-1, w] + b[b, t, w],   h[b, -1, w] = 0
//
// Replaces: src/repro/kernels/rglru_scan.py, `rglru_scan` / `_rglru_kernel`,
// the TPU kernel that carries the hidden state in VMEM across an in-order
// grid of (batch, 128-channel block, 256-step sequence tile) and runs the
// recurrence over each tile with a `fori_loop` on the vector unit.
//
// What bounds it on the H100: bytes.  Each step reads a and b and writes h
// (12 bytes a channel-step) and does one multiply and one add, so at the
// prefill shape of RecurrentGemma-2B (B = 2, S = 4096, W = 2560: 252 MB) the
// floor is 0.075 ms at 3.35 TB/s, against about 0.3 µs of arithmetic at the
// f32 peak.  The recurrence is sequential in t, so what limits a kernel is
// how many bytes it keeps in flight: by Little's law, 3.35 TB/s at about
// 1 µs of loaded latency needs 3-5 MB in flight across the card.  The first
// version (one thread a channel, 16 steps of loads ahead in registers) kept
// about 0.65 MB and ran at 3.3x the bound.
//
// Why the walk stays sequential: a chunked two-pass scan (per-chunk Π a and
// carried h, then a fix-up) would give the card more threads, but it rounds
// the products and the carries in another order, so the kernel would no
// longer equal its plain version bit for bit.  The bytes can reach the
// card's rate while each channel still walks t in order, so the exact
// design was kept.
//
// Design: an asynchronous shared-memory ring that feeds the walk.
//  * grid: one CTA for each (batch, block of CW consecutive channels);
//    64 threads, warp 0 the consumer, warp 1 the producer;
//  * producer: keeps a ring of stages full, each T steps x CW channels of
//    a and of b, completing on a full/empty mbarrier pair per stage;
//  * consumer: one thread a channel holds h in a register and walks t
//    through the ring in order, reading the stage 16 steps ahead of the
//    recurrence; it frees a stage on its empty barrier;
//  * two routes, chosen by shape (repro_rglru_scan_route):
//      - TMA (W % 4 == 0; a, b and h on 16-byte boundaries): the producer's
//        one lane issues two 3-D `cp.async.bulk.tensor` boxes (CW, T, 1) a
//        stage over the (W, S, B) tensors; the hardware zero-fills the
//        ragged last channel block and the steps past S and always counts
//        the whole box, so every stage expects 2·T·CW·4 bytes.  The
//        consumer writes each stage's h into one of two shared boxes and
//        one lane stores it with TMA, clipped at S and at the width (maps
//        encoded on the host through cudaGetDriverEntryPoint, without
//        linking libcuda).  Storing h to global memory itself, the consumer
//        waited each step on the store's read of the register that the
//        next step rewrote: about 14 ns a step at B = 1 (0.058 ms), 12 with
//        the boxes (0.051);
//      - cp.async (any other width or alignment, where a row is not a
//        16-byte multiple): the 32 producer lanes copy the stage's elements
//        that exist with 4-byte `cp.async`, each lane arriving on the full
//        barrier when its own copies land (`cp.async.mbarrier.arrive.noinc`),
//        and the consumer stores h[t] itself, lanes past the width nothing;
//  * bytes in flight: a stage is 2·T·CW·4 bytes, 16 KB at the default
//    (CW, T) = (32, 64).  The default plan takes as many stages, 2 to 4,
//    as bring the ring across the card to about 4 MB: 2 at the prefill
//    shape (160 CTAs, 5.2 MB), 4 at one prompt (80 CTAs, 5.2 MB).  On the
//    H100 a larger ring measured slower at the prefill shape (4 stages:
//    0.107 ms against 0.091) and no faster at one prompt
//    (scripts/k10_ab.py, PERF.md).  The two h boxes add a stage's bytes;
//  * h = __fadd_rn(__fmul_rn(a, h), b): two roundings, as the plain version
//    (torch.mul, then torch.add) and the Pallas body compute it; the
//    intrinsics keep nvcc from contracting them into one FMA, so the kernel
//    equals the plain version bit for bit at every shape and plan
//    (rglru_scan.scan_in_kernel_order renders this walk in PyTorch).
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 64;     // warp 0 consumes, warp 1 produces
constexpr int MAX_STAGES = 16;  // the barriers' room
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;
constexpr int AHEAD = 16;       // ring reads ahead of the recurrence
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

// the default plan: CW channels a CTA, T steps a stage, and as many stages
// (MIN_STAGES..MAX_PLAN_STAGES) as bring the ring across the card to about
// RING_BYTES (default_stages)
constexpr int CW = 32, T = 64, MIN_STAGES = 2, MAX_PLAN_STAGES = 4;
constexpr long long RING_BYTES = 4ll << 20;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int w, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(w), "r"(t), "r"(b)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}

// the (CW, T, 1) box at `src` in shared memory to the tensor of `map`
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int w, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n"
      ::"l"((uint64_t)map), "r"(src), "r"(w), "r"(t), "r"(b) : "memory");
}

// wait until at most N of this thread's bulk stores still read shared memory
template <int N>
__device__ __forceinline__ void tma_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// TMA_ROUTE: the maps describe a, b and h; otherwise the raw pointers are
// read and written
template <int CW_, int T_, bool TMA_ROUTE>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(__grid_constant__ const CUtensorMap map_a,
                  __grid_constant__ const CUtensorMap map_b,
                  __grid_constant__ const CUtensorMap map_h,
                  const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int seq, int width, int stages) {
  constexpr int STAGE = T_ * CW_;  // floats of a (and of b) a stage
  extern __shared__ unsigned char smem_raw[];
  // offset from the array itself, so that the compiler keeps the ring's
  // reads in the shared space (LDS, not generic loads)
  unsigned char* base =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const uint32_t bars = smem_u32(base);  // full[MAX_STAGES], empty[...]
  float* ring = (float*)(base + BAR_BYTES);
  float* out = ring + (size_t)stages * 2 * STAGE;  // TMA route: 2 h boxes
  const int blocks_w = (width + CW_ - 1) / CW_;
  const int bi = blockIdx.x / blocks_w;
  const int w0 = (blockIdx.x - bi * blocks_w) * CW_;
  const int n_stages = (seq + T_ - 1) / T_;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(bars + 8 * s, TMA_ROUTE ? 1 : 32);
      bar_init(bars + 8 * (MAX_STAGES + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {  // the producer
    const size_t row0 = (size_t)bi * seq;
    const int cw_here = min(CW_, width - w0);
    for (int i = 0; i < n_stages; ++i) {
      const int slot = i % stages;
      const uint32_t full = bars + 8 * slot;
      const uint32_t ra = smem_u32(ring + (size_t)slot * 2 * STAGE);
      const uint32_t rb = ra + STAGE * 4;
      if (TMA_ROUTE) {
        if (lane != 0) return;
        bar_wait(bars + 8 * (MAX_STAGES + slot), ((i / stages) & 1) ^ 1);
        bar_expect(full, 2 * STAGE * 4);
        tma_box(ra, &map_a, full, w0, i * T_, bi);
        tma_box(rb, &map_b, full, w0, i * T_, bi);
      } else {
        bar_wait(bars + 8 * (MAX_STAGES + slot), ((i / stages) & 1) ^ 1);
        const int t0 = i * T_;
        const int n = min(T_, seq - t0) * cw_here;
        const size_t g0 = (row0 + t0) * width + w0;
        for (int e = lane; e < n; e += 32) {
          const int r = e / cw_here, c = e - r * cw_here;
          const size_t g = g0 + (size_t)r * width + c;
          cp_async4(ra + 4 * (r * CW_ + c), a + g);
          cp_async4(rb + 4 * (r * CW_ + c), b + g);
        }
        cp_async_arrive(full);
      }
    }
    return;
  }

  // the consumer: lane c walks channel w0 + c; lanes past CW_ read a
  // neighbour's column and store nothing.  On the TMA route it writes each
  // stage's h into one of two shared boxes, which one lane stores with TMA
  // (clipped at S and at the width); otherwise it stores h[t] itself, lanes
  // past the width storing nothing
  const bool live = lane < CW_ && (TMA_ROUTE || w0 + lane < width);
  const int col = lane & (CW_ - 1);
  float* hp = h + (size_t)bi * seq * width + w0 + lane;
  float hv = 0.0f;
  for (int i = 0; i < n_stages; ++i) {
    const int slot = i % stages;
    float* ob = out + (i & 1) * STAGE + col;
    if (TMA_ROUTE) {
      if (lane == 0 && i >= 2) tma_store_read_wait<1>();  // stage i - 2's
      __syncwarp();
    }
    bar_wait(bars + 8 * slot, (i / stages) & 1);
    const float* as = ring + (size_t)slot * 2 * STAGE + col;
    const float* bs = as + STAGE;
    const int rows = min(T_, seq - i * T_);
    if (rows == T_) {
      constexpr int D = AHEAD < T_ ? AHEAD : T_;
      float av[D], bv[D];
#pragma unroll
      for (int u = 0; u < D; ++u) {
        av[u] = as[u * CW_];
        bv[u] = bs[u * CW_];
      }
#pragma unroll
      for (int u = 0; u < T_; ++u) {
        const float x = av[u % D], y = bv[u % D];
        if (u + D < T_) {
          av[u % D] = as[(u + D) * CW_];
          bv[u % D] = bs[(u + D) * CW_];
        }
        hv = __fadd_rn(__fmul_rn(x, hv), y);
        if (live) {
          if (TMA_ROUTE) ob[u * CW_] = hv;
          else hp[(size_t)u * width] = hv;
        }
      }
    } else {
      for (int u = 0; u < rows; ++u) {
        hv = __fadd_rn(__fmul_rn(as[u * CW_], hv), bs[u * CW_]);
        if (live) {
          if (TMA_ROUTE) ob[u * CW_] = hv;
          else hp[(size_t)u * width] = hv;
        }
      }
    }
    hp += (size_t)T_ * width;
    if (TMA_ROUTE)  // the box's writes, visible to the TMA unit
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      bar_arrive(bars + 8 * (MAX_STAGES + slot));
      if (TMA_ROUTE)
        tma_store(&map_h, smem_u32(out + (i & 1) * STAGE), w0, i * T_, bi);
    }
  }
  if (TMA_ROUTE && lane == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

using EncodeFn = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver the runtime loaded (no -lcuda)
EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeFn)p;
  }
  return fn;
}

// the (W, S, B) f32 tensor at `p` as a map of (cw, t, 1) boxes
bool encode(CUtensorMap* map, const void* p, int batch, int seq, int width,
            int cw, int t) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 4,
                                 (cuuint64_t)seq * width * 4};
  const cuuint32_t box[3] = {(cuuint32_t)cw, (cuuint32_t)t, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool tma_route(const void* a, const void* b, const void* h, int width) {
  return width % 4 == 0 && ((uintptr_t)a % 16) == 0 &&
         ((uintptr_t)b % 16) == 0 && ((uintptr_t)h % 16) == 0;
}

template <int CW_, int T_, bool TMA_ROUTE>
int launch(const void* a, const void* b, void* h, int batch, int seq,
           int width, int stages, cudaStream_t stream) {
  CUtensorMap map_a{}, map_b{}, map_h{};
  if (TMA_ROUTE && !(encode(&map_a, a, batch, seq, width, CW_, T_) &&
                     encode(&map_b, b, batch, seq, width, CW_, T_) &&
                     encode(&map_h, h, batch, seq, width, CW_, T_)))
    return (int)cudaErrorInvalidValue;
  const int boxes = stages + (TMA_ROUTE ? 1 : 0);  // the ring and h's two
  const size_t smem = 128 + BAR_BYTES + (size_t)boxes * 2 * T_ * CW_ * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const auto kernel = rglru_scan_kernel<CW_, T_, TMA_ROUTE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)batch * ((width + CW_ - 1) / CW_);
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      map_a, map_b, map_h, (const float*)a, (const float*)b, (float*)h, seq,
      width, stages);
  REPRO_LAUNCH_CHECK();
  return 0;
}

template <int CW_, int T_>
int launch_route(const void* a, const void* b, void* h, int batch, int seq,
                 int width, int stages, cudaStream_t stream) {
  return tma_route(a, b, h, width)
             ? launch<CW_, T_, true>(a, b, h, batch, seq, width, stages,
                                     stream)
             : launch<CW_, T_, false>(a, b, h, batch, seq, width, stages,
                                      stream);
}

}  // namespace

// a, b, h: (batch, seq, width) f32, contiguous; h must not alias a or b.
// `cw` channels a CTA (16 or 32), `t` steps a stage (32, 64 or 128),
// `stages` ring stages (2..16, within a block's shared memory).
extern "C" int repro_rglru_scan_plan(const void* a, const void* b, void* h,
                                     int batch, int seq, int width, int cw,
                                     int t, int stages, void* stream) {
  if ((long long)batch * width <= 0 || seq <= 0) return 0;
  if (stages < 2 || stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define REPRO_PLAN(C, TT)                                              \
  case C * 1000 + TT:                                                  \
    return launch_route<C, TT>(a, b, h, batch, seq, width, stages, s);
  switch (cw * 1000 + t) {
    REPRO_PLAN(16, 32)
    REPRO_PLAN(16, 64)
    REPRO_PLAN(16, 128)
    REPRO_PLAN(32, 32)
    REPRO_PLAN(32, 64)
    REPRO_PLAN(32, 128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_PLAN
}

// The default plan's stage count for `batch` x `width` channels.
extern "C" int repro_rglru_scan_stages(int batch, int width) {
  const long long ring = (long long)batch * ((width + CW - 1) / CW) * 2 * T *
                         CW * 4;  // one stage of every CTA
  const long long s = ring > 0 ? (RING_BYTES + ring - 1) / ring : 0;
  return (int)(s < MIN_STAGES ? MIN_STAGES
                              : s > MAX_PLAN_STAGES ? MAX_PLAN_STAGES : s);
}

// The default plan.
extern "C" int repro_rglru_scan(const void* a, const void* b, void* h,
                                int batch, int seq, int width, void* stream) {
  return repro_rglru_scan_plan(a, b, h, batch, seq, width, CW, T,
                               repro_rglru_scan_stages(batch, width), stream);
}

// 1 where the kernel moves a, b and h through TMA, 0 where through 4-byte
// cp.async and plain stores, for an h on a 16-byte boundary (the wrapper's).
extern "C" int repro_rglru_scan_route(const void* a, const void* b,
                                      int width) {
  return tma_route(a, b, nullptr, width) ? 1 : 0;
}
