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
// floor is 0.075 ms at 3.35 TB/s, against about 0.3 µs of arithmetic.  But
// the recurrence is sequential in t, so what limits a simple kernel is the
// latency of each step's loads, not the bandwidth.
//
// Design:
//  * one thread per (batch, channel), walking t in order; neighbouring
//    threads own neighbouring channels, so every load and store of a warp
//    is one coalesced 128-byte line;
//  * the loads of a[t] and b[t] do not depend on h, so the time loop is
//    unrolled by 16 and double-buffered: the next 16 steps' loads are issued
//    before this 16's arithmetic, keeping 32 loads a thread in flight;
//  * h = __fadd_rn(__fmul_rn(a, h), b): two roundings, as the plain version
//    (torch.mul, then torch.add) and the Pallas body compute it; the
//    intrinsics keep nvcc from contracting them into one FMA, so the kernel
//    equals the plain version bit for bit;
//  * ragged S and W are masked (the TPU kernel asserts that its blocks
//    divide them);
//  * one warp a block, so that the B·W threads (5,120 at the prefill shape)
//    spread over as many SMs as there are warps.  At that shape that is 160
//    warps for 132 SMs: far too few to hide the load latency.  A chunked
//    two-pass scan (per-chunk (Π a, h) carries, then a fix-up pass) would
//    give the card S/chunk times more threads; that is a later redesign.
#include "common.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int batch, int seq, int width) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)batch * width) return;
  const long long bi = idx / width;
  const long long w = idx - bi * width;
  const size_t base = (size_t)bi * seq * width + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;

  float a_cur[UNROLL], b_cur[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (u < seq) {
      a_cur[u] = __ldg(ap + (size_t)u * width);
      b_cur[u] = __ldg(bp + (size_t)u * width);
    }
  }
  float hv = 0.0f;
  for (int t0 = 0; t0 < seq; t0 += UNROLL) {
    const int t1 = t0 + UNROLL;
    float a_next[UNROLL], b_next[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t1 + u < seq) {
        a_next[u] = __ldg(ap + (size_t)(t1 + u) * width);
        b_next[u] = __ldg(bp + (size_t)(t1 + u) * width);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u < seq) {
        hv = __fadd_rn(__fmul_rn(a_cur[u], hv), b_cur[u]);
        hp[(size_t)(t0 + u) * width] = hv;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      a_cur[u] = a_next[u];
      b_cur[u] = b_next[u];
    }
  }
}

}  // namespace

// a, b, h: (batch, seq, width) f32, contiguous; h must not alias a or b.
extern "C" int repro_rglru_scan(const void* a, const void* b, void* h,
                                int batch, int seq, int width, void* stream) {
  const long long threads = (long long)batch * width;
  if (threads <= 0 || seq <= 0) return 0;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  rglru_scan_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, batch, seq, width);
  REPRO_LAUNCH_CHECK();
  return 0;
}
