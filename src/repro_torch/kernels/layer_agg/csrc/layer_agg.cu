// DR-FL layer-aligned aggregation (paper Step 2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/layer_agg/layer_agg.py
// (`layer_agg`, pallas_call at :43).  For stacked client updates U [N,R,D],
// row masks M [N,R] and data-size weights w [N]:
//
//   out[r,d] = sum_n w_n*M[n,r]*U[n,r,d] / max(sum_n w_n*M[n,r], 1e-12)
//
// and 0 where the denominator is 0 (a row no client trained).  All f32.
//
// Bound: every element of U is read once and every output written once,
// 2 flops per element of U, so the kernel is memory-bound.  On the stacked
// DR-FL path (N <= 9 at 64 devices, R = 11084, D = 1024) that is ~409 MB
// in and ~45 MB out: ~0.14 ms at the H100 SXM data sheet's 3.35 TB/s.
//
// Design (simple first): one block per (row r, chunk of d); threads stride
// over d, so a warp's loads of one client row are coalesced; a loop over
// ALL N clients accumulates w*m*u and w*m in f32.  The TPU kernel kept every
// client in one tile and assumed N <= ~64; here the per-client factors w*m
// are staged through shared memory in tiles of kTileN, so N is unbounded
// (the server concatenates every pow2-padded bucket, so N is the whole
// padded cohort).  No atomics: each output element has one owner thread,
// and the sum over n runs in client order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;   // d values per block
constexpr int kTileN = 256;    // clients staged in shared memory at a time

__global__ void __launch_bounds__(kThreads)
layer_agg_kernel(const float* __restrict__ U, const float* __restrict__ M,
                 const float* __restrict__ W, float* __restrict__ out,
                 int N, int R, int D) {
  __shared__ float wm_tile[kTileN];
  const int r = blockIdx.x;
  const int d0 = blockIdx.y * kChunk;
  constexpr int kPer = kChunk / kThreads;
  float num[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) num[j] = 0.f;
  float den = 0.f;

  for (int n0 = 0; n0 < N; n0 += kTileN) {
    const int nt = min(kTileN, N - n0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += kThreads) {
      const int n = n0 + i;
      wm_tile[i] = W[n] * M[(size_t)n * R + r];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < nt; ++i) {
      const float wm = wm_tile[i];
      den += wm;
      const float* u = U + ((size_t)(n0 + i) * R + r) * D;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int d = d0 + threadIdx.x + j * kThreads;
        if (d < D) num[j] += wm * u[d];
      }
    }
  }

  float* o = out + (size_t)r * D;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = d0 + threadIdx.x + j * kThreads;
    if (d < D) o[d] = den > 0.f ? num[j] / fmaxf(den, 1e-12f) : 0.f;
  }
}

}  // namespace

// C entry point for ctypes.  Launches on `stream` (PyTorch's current
// stream) on the calling thread's current device, which the caller sets;
// changes no device state, does not synchronise, allocates nothing;
// returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int layer_agg_launch(const float* U, const float* M,
                                const float* W, float* out, int N, int R,
                                int D, void* stream) {
  if (R == 0 || D == 0) return 0;
  dim3 grid((unsigned)R, (unsigned)((D + kChunk - 1) / kChunk));
  layer_agg_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      U, M, W, out, N, R, D);
  return (int)cudaGetLastError();
}
