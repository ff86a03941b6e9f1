// K10-bwd — the gradient of K10's recurrence h_t = a_t ⊙ h_{t-1} + b_t, on
// the CUDA cores:
//
//   g_t  = dh_t + a_{t+1} · g_{t+1}      (g_S = 0, a_S = 0)
//   db_t = g_t,   da_t = g_t · h_{t-1}    (h_{-1} = 0)
//
// the reverse-time walk, with da and db written in the same pass.
//
// Replaces no TPU kernel: the JAX package trains RG-LRU blocks through
// `jax.lax.associative_scan` and differentiates that, and its Pallas scan
// (src/repro/kernels/rglru_scan.py) has no backward.  The port's training
// runs the scan through K10 (rglru_scan.cu), and this is its backward, the
// `torch.autograd.Function` of kernels/ops.py:rglru.
//
// What bounds it on the H100: bytes.  Each step reads a, h and dh and
// writes da and db (20 bytes a channel-step) for two multiplies and an add,
// so at a training microbatch of RecurrentGemma-2B (B = 1, S = 4096,
// W = 2560: 210 MB) the floor is 0.063 ms at 3.35 TB/s.  This first version
// is simple: one thread a (batch, channel) walks t from S − 1 down to 0
// (neighbouring threads on neighbouring channels, so each step's loads of a
// warp are one 128-byte line), with the next AHEAD steps of a, h and dh
// loaded into registers while the current ones are used.  Its bytes in
// flight are B·W·3·AHEAD·4 (1 MB at that shape), far below the 3-5 MB
// K10's forward ring keeps, so it runs under the byte rate; a reverse
// instantiation of that ring is later work.
//
// Each step takes the same two roundings as the plain version
// (`torch.mul`, then `torch.add`), through intrinsics that nvcc does not
// contract into an FMA, so the kernel equals `ref.rglru_scan_bwd_ref` bit
// for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int AHEAD = 16;   // steps loaded ahead of the walk

// the AHEAD steps [t - AHEAD + 1, t] of channel `col` (t counts down);
// steps below 0 read as a = 0, h = 0, dh = 0 and are never used
__device__ __forceinline__ void load_block(const float* a, const float* h,
                                           const float* dh, size_t base,
                                           int width, int t, float (&av)[AHEAD],
                                           float (&hv)[AHEAD],
                                           float (&dv)[AHEAD]) {
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) {
    const int tt = t - u;
    const bool in = tt >= 0;
    const size_t at = base + (size_t)(in ? tt : 0) * width;
    av[u] = in ? a[at] : 0.0f;
    hv[u] = in ? h[at] : 0.0f;
    dv[u] = in ? dh[at] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ dh, float* __restrict__ da,
                 float* __restrict__ db, int batch, int seq, int width) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)batch * width) return;
  const int bi = (int)(idx / width);
  const int col = (int)(idx - (long long)bi * width);
  const size_t base = (size_t)bi * seq * width + col;

  float ca[AHEAD], ch[AHEAD], cd[AHEAD];  // the block being walked
  float na[AHEAD], nh[AHEAD], nd[AHEAD];  // the next one, in flight
  load_block(a, h, dh, base, width, seq - 1, ca, ch, cd);
  float g = 0.0f, a_next = 0.0f;
  for (int t0 = seq - 1; t0 >= 0; t0 -= AHEAD) {
    if (t0 - AHEAD >= 0)
      load_block(a, h, dh, base, width, t0 - AHEAD, na, nh, nd);
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int t = t0 - u;
      if (t < 0) break;
      g = __fadd_rn(cd[u], __fmul_rn(a_next, g));
      // h_{t-1}: the next register of this block, or the first of the
      // next block, or 0 before the sequence
      const float h_prev = u + 1 < AHEAD ? ch[u + 1]
                                         : (t > 0 ? nh[0] : 0.0f);
      const size_t at = base + (size_t)t * width;
      db[at] = g;
      da[at] = __fmul_rn(g, t > 0 ? h_prev : 0.0f);
      a_next = ca[u];
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      ca[u] = na[u];
      ch[u] = nh[u];
      cd[u] = nd[u];
    }
  }
}

}  // namespace

// a, h, dh, da, db: (batch, seq, width) f32, contiguous; da and db must not
// alias the inputs.
extern "C" int repro_rglru_scan_bwd(const void* a, const void* h,
                                    const void* dh, void* da, void* db,
                                    int batch, int seq, int width,
                                    void* stream) {
  const long long n = (long long)batch * width;
  if (n <= 0 || seq <= 0) return 0;
  rglru_bwd_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h, (const float*)dh, (float*)da,
      (float*)db, batch, seq, width);
  REPRO_LAUNCH_CHECK();
  return 0;
}
