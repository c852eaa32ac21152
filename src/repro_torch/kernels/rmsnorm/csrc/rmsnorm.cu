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
// Bound: both kernels read their inputs once and write their outputs once
// with a few flops per element, so both are memory-bound.  At the
// transformer path's block norms (G = 16 participants, R = 1024 rows,
// d = 128, f32) the forward moves 16.8 MB (~5 us at the H100 SXM data
// sheet's 3.35 TB/s) and the backward 25.2 MB (~7.5 us).  At one client's
// shape (G = 1) the data is 16x smaller and latency (one round trip to
// memory, the launch) is the limit: there the design spreads rows over
// the SMs and keeps several rows' loads in flight per warp.
//
// Two routes, chosen by the wrapper from the shape and the pointers before
// the launch (rmsnorm.py: rmsnorm_route), never after a failure:
//
// * vec: d % V == 0 (V = 16 bytes of T: 4 f32 or 8 bf16), d <= kVecMaxD,
//   every pointer 16-byte aligned.  Lane l of a warp owns the vectors
//   l, l + 32, ... of a row, loaded with one 16-byte load each, and keeps
//   the row in registers: the forward reduces it with a shuffle and writes
//   y and rstd without reading x again; the backward computes c, dx and
//   its dscale terms from the same registers.  A warp loads several rows
//   (2 in the forward; up to 4 in the backward, fewer for wide rows, to
//   bound registers) and the forward their scale rows before it reduces
//   any, so one row's memory latency overlaps the next's.
// * general: any d and alignment (d not a multiple of V, d over the
//   register cap, a view that starts off the 16-byte grid); lanes stride
//   over d with scalar loads, the forward re-reads x for its second pass
//   and the backward keeps its dscale terms in a global scratch row per
//   warp.  The same one-launch reduction as the vec route.
//
// Backward: one launch, no float atomics, deterministic.  Each group's R
// rows are split into S <= kMaxSplits contiguous splits (S from the SM
// count: enough blocks to spread one group over the card, few enough that
// the last step is short); block (g, s) runs kBwdWarps warps, each over a
// contiguous run of rows in row order, each lane summing dy * x * r for
// its own columns (no shuffle).  The block adds its warps' sums in warp
// order; with one split that is dscale[g], else it goes to a [G, S, d]
// scratch and one thread takes an integer ticket for the group (atom.add
// with release and acquire semantics, after the block's barrier: no
// per-thread fence), and the group's last block adds the S partials in
// split order, writes dscale[g] and puts the ticket back to 0 for the
// next call on the stream.  A warp's last rows stay in registers and write their dx after
// the ticket, so the release does not wait for those stores.  So dx and
// dscale are the same bits on every call, and rmsnorm.py's
// rmsnorm_bwd_blocked repeats the order on the CPU.  (A thread-block
// cluster per group reduced through distributed shared memory needs no
// ticket, but would put one group on at most 16 of the 132 SMs: at G = 1,
// the per-client executor's shape, the card would be 88% idle.)  The sums
// are written with __fadd_rn / __fmul_rn so that nvcc contracts none of
// them into an FMA, which keeps the kernel's arithmetic that of the
// emulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kFwdWarps = 4;      // forward: warps per block
constexpr int kFwdRows = 2;       // forward: rows a warp loads together
constexpr int kFwdBlocksPerSM = 16;
constexpr int kBwdWarps = 8;      // backward: warps per block
constexpr int kMaxSplits = 32;    // backward: splits of a group's rows
constexpr int kVecMaxD = 1024;    // vec route: values per row

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

// 16 bytes of T <-> V floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* o) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i],
                                                             o[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cache[dev] > 0) return cache[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n < 1) n = 1;
  if (dev >= 0 && dev < 64) cache[dev] = n;
  return n;
}

// ---------------------------------------------------------------- forward

// vec route: K vectors of V values per lane (K * V * 32 >= d); a warp
// loads kFwdRows rows of x and their groups' scale rows together before it
// reduces any; blocks stride over the rows.
template <typename T, int K>
__global__ void __launch_bounds__(kFwdWarps * 32)
rmsnorm_fwd_vec(const T* __restrict__ x, const T* __restrict__ scale,
                T* __restrict__ y, float* __restrict__ rstd, long long rows,
                int R, int d, float eps) {
  constexpr int V = Vec<T>::V;
  const int lane = threadIdx.x % 32;
  const int nv = d / V;
  const long long warps = (long long)gridDim.x * kFwdWarps;
  for (long long r0 = ((long long)blockIdx.x * kFwdWarps + threadIdx.x / 32)
                      * kFwdRows;
       r0 < rows; r0 += warps * kFwdRows) {
    float xv[kFwdRows][K * V], sv[kFwdRows][K * V];
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = lane + 32 * k;
        if (r0 + i < rows && v < nv) {
          Vec<T>::load(x + (r0 + i) * d + (long long)v * V, &xv[i][k * V]);
          Vec<T>::load(scale + (r0 + i) / R * d + (long long)v * V,
                       &sv[i][k * V]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            xv[i][k * V + e] = sv[i][k * V + e] = 0.f;
        }
      }
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) {
      const long long row = r0 + i;
      if (row >= rows) break;                // whole warp: same row
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < K * V; ++j)
        ss = __fadd_rn(ss, __fmul_rn(xv[i][j], xv[i][j]));
      ss = warp_sum(ss);
      const float r = 1.f / sqrtf(ss / (float)d + eps);
      if (lane == 0) rstd[row] = r;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = lane + 32 * k;
        if (v >= nv) break;
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e)
          out[e] = __fmul_rn(__fmul_rn(xv[i][k * V + e], r), sv[i][k * V + e]);
        Vec<T>::store(y + row * d + (long long)v * V, out);
      }
    }
  }
}

// general route: one warp per row, lanes stride over d, x read twice.
template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32)
rmsnorm_fwd_general(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ y, float* __restrict__ rstd,
                    long long rows, int R, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * kFwdWarps;
  for (long long row = (long long)blockIdx.x * kFwdWarps + threadIdx.x / 32;
       row < rows; row += warps) {
    const T* xr = x + row * d;
    const T* s = scale + (row / R) * d;
    float ss = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = to_f(xr[j]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    ss = warp_sum(ss);
    const float r = 1.f / sqrtf(ss / (float)d + eps);
    if (lane == 0) rstd[row] = r;
    T* yr = y + row * d;
    for (int j = lane; j < d; j += 32)
      yr[j] = from_f<T>(__fmul_rn(__fmul_rn(to_f(xr[j]), r), to_f(s[j])));
  }
}

// --------------------------------------------------------------- backward

struct Split {            // the rows [lo, hi) of group g that a warp owns
  int g, s, lo, hi;
};

__device__ __forceinline__ Split warp_rows(int R, int S) {
  Split p;
  p.g = blockIdx.x / S;
  p.s = blockIdx.x % S;
  const int rps = (R + S - 1) / S;                        // rows per split
  const int rpw = (rps + kBwdWarps - 1) / kBwdWarps;      // rows per warp
  const int end = min(R, (p.s + 1) * rps);
  p.lo = min(end, p.s * rps + (int)(threadIdx.x / 32) * rpw);
  p.hi = min(end, p.lo + rpw);
  return p;
}

// The block's warps' sums (warp w's at wp[w * stride + j]) in warp order.
// With one split they are dscale[g]: written, and *last is 0.  Else they
// go to the group's scratch row s, and one thread, after the block's
// barrier, takes the group's ticket with release and acquire semantics (so
// the whole block's scratch writes are visible to whoever takes the last
// ticket, and the last block sees every other block's); *last says
// whether this block took the last one.
template <typename T>
__device__ __forceinline__ void publish(const float* wp, int stride,
                                        float* __restrict__ part,
                                        int* __restrict__ tickets,
                                        T* __restrict__ dscale, int g, int s,
                                        int S, int d, int* last) {
  float* row = part + ((size_t)g * S + s) * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float t = wp[j];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w)
      t = __fadd_rn(t, wp[(size_t)w * stride + j]);
    if (S == 1)
      dscale[(size_t)g * d + j] = from_f<T>(t);
    else
      row[j] = t;
  }
  if (S == 1) {
    if (threadIdx.x == 0) *last = 0;
    return;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(old) : "l"(tickets + g) : "memory");
    *last = old == S - 1;
  }
}

// The group's last block adds the S scratch rows in split order into
// dscale[g] and puts the ticket back to 0.
template <typename T>
__device__ __forceinline__ void finish(const float* __restrict__ part,
                                       int* __restrict__ tickets,
                                       T* __restrict__ dscale, int g, int S,
                                       int d, const int* last) {
  __syncthreads();
  if (!*last) return;
  const float* rows = part + (size_t)g * S * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float v[kMaxSplits];
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i)
      v[i] = i < S ? __ldcg(rows + (size_t)i * d + j) : 0.f;
    float t = v[0];
#pragma unroll
    for (int i = 1; i < kMaxSplits; ++i)
      if (i < S) t = __fadd_rn(t, v[i]);
    dscale[(size_t)g * d + j] = from_f<T>(t);
  }
  if (threadIdx.x == 0) tickets[g] = 0;
}

// vec route: K vectors a lane, NR rows a warp loaded together.  Each batch
// of rows adds its dscale terms in registers, then writes its dx; the last
// batch stays in registers and writes its dx after the block has taken its
// ticket, so the stores do not delay it.  The warps' sums meet in dynamic
// shared memory, kBwdWarps rows of d floats.
template <typename T, int K, int NR>
__device__ __forceinline__ void bwd_rows_dx(
    const float (&xv)[NR][K * Vec<T>::V], const float (&dv)[NR][K * Vec<T>::V],
    const float (&rs)[NR], const float (&sc)[K * Vec<T>::V],
    T* __restrict__ dx, size_t row0, int n, int lane, int nv, int d) {
  constexpr int V = Vec<T>::V;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (i >= n) break;                       // whole warp: same rows
    float c = 0.f;
#pragma unroll
    for (int j = 0; j < K * V; ++j)
      c = __fadd_rn(c, __fmul_rn(__fmul_rn(dv[i][j], sc[j]), xv[i][j]));
    c = warp_sum(c);
    const float r = rs[i];
    const float kk = __fmul_rn(__fmul_rn(__fmul_rn(r, r), r), c / (float)d);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = lane + 32 * k;
      if (v >= nv) break;
      float out[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = k * V + e;
        out[e] = __fsub_rn(__fmul_rn(r, __fmul_rn(dv[i][j], sc[j])),
                           __fmul_rn(xv[i][j], kk));
      }
      Vec<T>::store(dx + (row0 + i) * d + (size_t)v * V, out);
    }
  }
}

// rows a warp loads together: 4 for narrow rows, fewer for wide ones, so
// that their x and dy stay at 32 floats a lane; and the blocks an SM should
// hold (64 registers a thread for rows of up to 8 floats a lane)
__host__ __device__ constexpr int bwd_rows(int floats) {
  return floats <= 4 ? 4 : floats <= 8 ? 2 : 1;
}
__host__ __device__ constexpr int bwd_min_blocks(int floats) {
  return floats <= 8 ? 4 : floats <= 16 ? 2 : 1;
}

template <typename T, int K, int NR>
__global__ void __launch_bounds__(kBwdWarps * 32,
                                  bwd_min_blocks(K * Vec<T>::V))
rmsnorm_bwd_vec(const T* __restrict__ x, const T* __restrict__ scale,
                const T* __restrict__ dy, const float* __restrict__ rstd,
                T* __restrict__ dx, T* __restrict__ dscale,
                float* __restrict__ part, int* __restrict__ tickets, int R,
                int d, int S) {
  constexpr int V = Vec<T>::V;
  extern __shared__ float wsum[];            // [kBwdWarps][d]
  __shared__ int last;
  const Split p = warp_rows(R, S);
  const int lane = threadIdx.x % 32;
  const int nv = d / V;
  const size_t base = (size_t)p.g * R;
  float sc[K * V], acc[K * V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = lane + 32 * k;
    if (v < nv)
      Vec<T>::load(scale + (size_t)p.g * d + (size_t)v * V, &sc[k * V]);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (v >= nv) sc[k * V + e] = 0.f;
      acc[k * V + e] = 0.f;
    }
  }
  float xv[NR][K * V], dv[NR][K * V], rs[NR];
  int r0 = p.lo;
  for (;;) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const bool ok = r0 + i < p.hi;
      rs[i] = ok ? rstd[base + r0 + i] : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = lane + 32 * k;
        const size_t at = (base + r0 + i) * d + (size_t)v * V;
        if (ok && v < nv) {
          Vec<T>::load(x + at, &xv[i][k * V]);
          Vec<T>::load(dy + at, &dv[i][k * V]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            xv[i][k * V + e] = dv[i][k * V + e] = 0.f;
        }
      }
    }
    // rows past the warp's end hold zeros and add nothing
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < K * V; ++j)
        if (r0 + i < p.hi)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(__fmul_rn(dv[i][j], xv[i][j]),
                                               rs[i]));
    if (r0 + NR >= p.hi) break;
    bwd_rows_dx<T, K, NR>(xv, dv, rs, sc, dx, base + r0, NR, lane, nv, d);
    r0 += NR;
  }
  float* mine = wsum + (threadIdx.x / 32) * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = lane + 32 * k;
    if (v < nv)
#pragma unroll
      for (int e = 0; e < V; ++e) mine[v * V + e] = acc[k * V + e];
  }
  __syncthreads();
  publish<T>(wsum, d, part, tickets, dscale, p.g, p.s, S, d, &last);
  bwd_rows_dx<T, K, NR>(xv, dv, rs, sc, dx, base + r0, p.hi - r0, lane, nv,
                        d);
  finish<T>(part, tickets, dscale, p.g, S, d, &last);
}

// general route: lanes stride over d; each warp's dscale terms build up in
// its own scratch row (wpart [G * S * kBwdWarps, d]; a lane's columns are
// its own, so no two threads touch one address).
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
rmsnorm_bwd_general(const T* __restrict__ x, const T* __restrict__ scale,
                    const T* __restrict__ dy,
                    const float* __restrict__ rstd, T* __restrict__ dx,
                    T* __restrict__ dscale, float* __restrict__ part,
                    float* __restrict__ wpart, int* __restrict__ tickets,
                    int R, int d, int S) {
  const Split p = warp_rows(R, S);
  const int lane = threadIdx.x % 32;
  const T* s = scale + (size_t)p.g * d;
  float* wblock = wpart + (size_t)blockIdx.x * kBwdWarps * d;
  float* mine = wblock + (size_t)(threadIdx.x / 32) * d;
  for (int j = lane; j < d; j += 32) mine[j] = 0.f;
  for (int row = p.lo; row < p.hi; ++row) {
    const size_t i = (size_t)p.g * R + row;
    const T* xr = x + i * d;
    const T* dyr = dy + i * d;
    float c = 0.f;
    for (int j = lane; j < d; j += 32)
      c = __fadd_rn(c, __fmul_rn(__fmul_rn(to_f(dyr[j]), to_f(s[j])),
                                 to_f(xr[j])));
    c = warp_sum(c);
    const float r = rstd[i];
    const float kk = __fmul_rn(__fmul_rn(__fmul_rn(r, r), r), c / (float)d);
    T* dxr = dx + i * d;
    for (int j = lane; j < d; j += 32) {
      const float xj = to_f(xr[j]), dj = to_f(dyr[j]);
      dxr[j] = from_f<T>(__fsub_rn(__fmul_rn(r, __fmul_rn(dj, to_f(s[j]))),
                                   __fmul_rn(xj, kk)));
      mine[j] = __fadd_rn(mine[j], __fmul_rn(__fmul_rn(dj, xj), r));
    }
  }
  __syncthreads();
  __shared__ int last;
  publish<T>(wblock, d, part, tickets, dscale, p.g, p.s, S, d, &last);
  finish<T>(part, tickets, dscale, p.g, S, d, &last);
}

// ---------------------------------------------------------------- launches

template <typename T>
bool vec_ok(const void* const* ptrs, int n, int d) {
  if (d % Vec<T>::V != 0 || d > kVecMaxD) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

// go(K) with K, the vectors a lane holds, the next power of two of
// ceil(d / V / 32): 1, 2, 4 or (float32 only, d <= kVecMaxD) 8
template <typename T, typename F>
void with_lane_vectors(int d, F&& go) {
  constexpr int kmax = kVecMaxD / Vec<T>::V / 32;
  const int need = (d / Vec<T>::V + 31) / 32;
  if (need <= 1) {
    go(std::integral_constant<int, 1>{});
  } else if (need <= 2) {
    go(std::integral_constant<int, 2>{});
  } else if (need <= 4) {
    go(std::integral_constant<int, 4>{});
  } else if constexpr (kmax >= 8) {
    go(std::integral_constant<int, 8>{});
  }
}

template <typename T>
int fwd(const void* x, const void* scale, void* y, float* rstd, int G, int R,
        int d, float eps, int vec, cudaStream_t stream) {
  const long long rows = (long long)G * R;
  const long long want = (rows + kFwdWarps * kFwdRows - 1)
                         / (kFwdWarps * kFwdRows);
  const long long cap = (long long)sm_count() * kFwdBlocksPerSM;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  const T* xp = (const T*)x;
  const T* sp = (const T*)scale;
  T* yp = (T*)y;
  if (vec) {
    const void* ptrs[] = {x, scale, y};
    if (!vec_ok<T>(ptrs, 3, d)) return (int)cudaErrorInvalidValue;
    with_lane_vectors<T>(d, [&](auto k) {
      rmsnorm_fwd_vec<T, decltype(k)::value>
          <<<blocks, kFwdWarps * 32, 0, stream>>>(xp, sp, yp, rstd, rows, R,
                                                  d, eps);
    });
  } else {
    rmsnorm_fwd_general<T><<<blocks, kFwdWarps * 32, 0, stream>>>(
        xp, sp, yp, rstd, rows, R, d, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* scale, const void* dy, const float* rstd,
        void* dx, void* dscale, float* scratch, int* tickets, int G, int R,
        int d, int S, int vec, cudaStream_t stream) {
  if (S < 1 || S > kMaxSplits || (R > 0 && S > R) ||
      (long long)G * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const T* xp = (const T*)x;
  const T* sp = (const T*)scale;
  const T* dyp = (const T*)dy;
  T* dxp = (T*)dx;
  T* dsp = (T*)dscale;
  const unsigned blocks = (unsigned)G * S;
  if (vec) {
    const void* ptrs[] = {x, scale, dy, dx};
    if (!vec_ok<T>(ptrs, 4, d)) return (int)cudaErrorInvalidValue;
    with_lane_vectors<T>(d, [&](auto k) {
      constexpr int K = decltype(k)::value;
      rmsnorm_bwd_vec<T, K, bwd_rows(K * Vec<T>::V)>
          <<<blocks, kBwdWarps * 32, kBwdWarps * d * sizeof(float), stream>>>(
              xp, sp, dyp, rstd, dxp, dsp, scratch, tickets, R, d, S);
    });
  } else {
    float* wpart = scratch + (size_t)G * S * d;
    rmsnorm_bwd_general<T><<<blocks, kBwdWarps * 32, 0, stream>>>(
        xp, sp, dyp, rstd, dxp, dsp, scratch, wpart, tickets, R, d, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points for ctypes.  dtype: 0 = float32, 1 = bfloat16; vec: 1 for
// the vec route (refused with cudaErrorInvalidValue where its conditions
// do not hold), 0 for the general route.  Each launches one kernel on
// `stream` (PyTorch's current stream) on the current device, which the
// caller sets; changes no device state, does not synchronise, allocates
// nothing; returns the cudaError_t of its launch (0 = cudaSuccess).

extern "C" int rmsnorm_fwd_launch(const void* x, const void* scale, void* y,
                                  float* rstd, int G, int R, int d,
                                  float eps, int vec, int dtype,
                                  void* stream) {
  if ((long long)G * R == 0 || d == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return fwd<float>(x, scale, y, rstd, G, R, d, eps, vec, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, scale, y, rstd, G, R, d, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: S splits a group (1 <= S <= 32, S <= R where R > 0).
// scratch: G * S * d floats, and G * S * 8 * d more for the general route;
// tickets: G ints, 0 before the call and 0 again after it (the kernel puts
// each back), so one ticket array serves every call on one stream.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* dy, const float* rstd, void* dx,
                                  void* dscale, float* scratch, int* tickets,
                                  int G, int R, int d, int S, int vec,
                                  int dtype, void* stream) {
  if (G == 0 || d == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd<float>(x, scale, dy, rstd, dx, dscale, scratch, tickets, G, R,
                      d, S, vec, s);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, scale, dy, rstd, dx, dscale, scratch,
                              tickets, G, R, d, S, vec, s);
  return (int)cudaErrorInvalidValue;
}
