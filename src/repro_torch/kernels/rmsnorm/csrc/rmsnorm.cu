// RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py
// (`rmsnorm` :20, pallas_call at :25; its oracle is rmsnorm/ref.py).  For
// rows x [G, R, d] with one scale row per group, scale [G, d]:
//
//   y[g,r,:] = x[g,r,:] * rstd[g,r] * scale[g,:]
//   rstd[g,r] = 1 / sqrt(mean(x[g,r,:]^2) + eps)
//
// computed in f32 and stored in x's type (f32 or bf16).  G = 1 is the JAX
// interface; G > 1 is the participant axis written out, since each client
// trains its own scales.  The TPU kernel had no backward (JAX cannot
// reverse-differentiate it); this file adds one:
//
//   dx = r * (dy * s) - x * r^3 * mean(dy * s * x)      (per row)
//   dscale[g,:] = sum over the group's rows of dy * x * r
//
// Bound: every kernel here reads its inputs once and writes its outputs
// once with a few flops per element, so all three are memory-bound.  At
// the transformer path's block norms (G = 16 participants, R = 1024 rows,
// d = 128, f32) the forward moves 16.8 MB: ~5 us at the H100 SXM data
// sheet's 3.35 TB/s.
//
// Design (simple first): one warp per row; lanes stride over d, so a
// warp's loads are coalesced and ragged d (any width) is masked by the
// loop bound; the row sum is a shuffle reduction in f32.  The second
// pass over the row re-reads x from L1/L2.  The TPU wrapper's power-of-
// two row blocks do not carry over: a grid of warps covers any row count.
// dscale is reduced without atomics, so it is deterministic: one block per
// (group, 32 columns); 16 row slices each sum their rows in order, then
// one thread per column adds the 16 partials in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // rows per block, forward and dx
constexpr int kCols = 32;        // dscale: columns per block
constexpr int kSlices = 16;      // dscale: row slices per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ y, float* __restrict__ rstd,
                   long long rows, int R, int d, float eps) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                 // whole warp: same row
  const T* xr = x + row * d;
  const T* s = scale + (row / R) * d;
  float ss = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = to_f(xr[j]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const float r = 1.f / sqrtf(ss / (float)d + eps);
  if (lane == 0) rstd[row] = r;
  T* yr = y + row * d;
  for (int j = lane; j < d; j += 32)
    yr[j] = from_f<T>(to_f(xr[j]) * r * to_f(s[j]));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                      const T* __restrict__ dy,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      long long rows, int R, int d) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + row * d;
  const T* dyr = dy + row * d;
  const T* s = scale + (row / R) * d;
  float c = 0.f;
  for (int j = lane; j < d; j += 32)
    c += to_f(dyr[j]) * to_f(s[j]) * to_f(xr[j]);
  c = warp_sum(c);
  const float r = rstd[row];
  const float k = r * r * r * (c / (float)d);
  T* dxr = dx + row * d;
  for (int j = lane; j < d; j += 32)
    dxr[j] = from_f<T>(r * (to_f(dyr[j]) * to_f(s[j])) - to_f(xr[j]) * k);
}

template <typename T>
__global__ void __launch_bounds__(kCols * kSlices)
rmsnorm_bwd_dscale_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ rstd,
                          T* __restrict__ dscale, int R, int d) {
  __shared__ float part[kSlices][kCols + 1];
  const int g = blockIdx.y;
  const int j = blockIdx.x * kCols + threadIdx.x;
  float acc = 0.f;
  if (j < d) {
    const size_t base = (size_t)g * R;
    for (int r = threadIdx.y; r < R; r += kSlices) {
      const size_t i = base + r;
      acc += to_f(dy[i * d + j]) * to_f(x[i * d + j]) * rstd[i];
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < d) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) s += part[k][threadIdx.x];
    dscale[(size_t)g * d + j] = from_f<T>(s);
  }
}

template <typename T>
int fwd(const void* x, const void* scale, void* y, float* rstd, int G, int R,
        int d, float eps, cudaStream_t stream) {
  const long long rows = (long long)G * R;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  rmsnorm_fwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      (const T*)x, (const T*)scale, (T*)y, rstd, rows, R, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* scale, const void* dy, const float* rstd,
        void* dx, void* dscale, int G, int R, int d, cudaStream_t stream) {
  const long long rows = (long long)G * R;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  rmsnorm_bwd_dx_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      (const T*)x, (const T*)scale, (const T*)dy, rstd, (T*)dx, rows, R, d);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dim3 grid((unsigned)((d + kCols - 1) / kCols), (unsigned)G);
  rmsnorm_bwd_dscale_kernel<T><<<grid, dim3(kCols, kSlices), 0, stream>>>(
      (const T*)x, (const T*)dy, rstd, (T*)dscale, R, d);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points for ctypes.  dtype: 0 = float32, 1 = bfloat16.  Each
// launches on `stream` (PyTorch's current stream) on the current device,
// which the caller sets; changes no device state, does not synchronise,
// allocates nothing; returns the cudaError_t of its launches (0 =
// cudaSuccess).

extern "C" int rmsnorm_fwd_launch(const void* x, const void* scale, void* y,
                                  float* rstd, int G, int R, int d,
                                  float eps, int dtype, void* stream) {
  if ((long long)G * R == 0 || d == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return fwd<float>(x, scale, y, rstd, G, R, d, eps, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, scale, y, rstd, G, R, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* dy, const float* rstd, void* dx,
                                  void* dscale, int G, int R, int d,
                                  int dtype, void* stream) {
  if (G == 0 || d == 0) return 0;
  if (R == 0) return (int)cudaMemsetAsync(
      dscale, 0, (size_t)G * d * (dtype == 0 ? 4 : 2), (cudaStream_t)stream);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd<float>(x, scale, dy, rstd, dx, dscale, G, R, d, s);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, scale, dy, rstd, dx, dscale, G, R, d, s);
  return (int)cudaErrorInvalidValue;
}
