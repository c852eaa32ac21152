// Shared pieces of the flash-attention kernels (forward, fused backward,
// three-pass backward): storage types, masks, the strided layout and the
// asynchronous tile loader.
//
// Layout: every tensor is [B, H, S, D] in index space, with D contiguous
// and free strides for batch, head and position, so the model layout
// [B, S, H, D] and the heads-first [BH, S, D] both reach the kernels
// without a copy.  Query head h of batch b reads KV head h / group of the
// same batch (GQA).  lse and delta are always [B * Hq, Sq] contiguous f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr float kMasked = -1e30f;         // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

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

// four consecutive elements from shared memory, as floats (16 bytes of
// f32 or 8 of bf16; the caller keeps the address aligned to that)
__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  x[0] = fa.x; x[1] = fa.y; x[2] = fb.x; x[3] = fb.y;
}

// four floats to global memory at p (elements d0..d0+3 of a row of D):
// one vector store when the layout is aligned, else element by element
__device__ __forceinline__ void st4(float* p, const float (&x)[4], int d0,
                                    int D, bool vec) {
  if (vec && d0 + 4 <= D) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d0 + e < D) p[e] = x[e];
  }
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&x)[4],
                                    int d0, int D, bool vec) {
  if (vec && d0 + 4 <= D) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&a);
    u.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d0 + e < D) p[e] = __float2bfloat16(x[e]);
  }
}

// strides of one tensor, in elements: batch, head, position (D is 1)
struct Lay {
  long long sb, sh, ss;
  __device__ __forceinline__ long long at(int b, int h, int s) const {
    return (long long)b * sb + (long long)h * sh + (long long)s * ss;
  }
};

struct Masks {
  int Sq, Sk, causal, window;
  // first and last key that query position q sees; lo > hi: none
  __device__ __forceinline__ int lo(int q) const {
    return window > 0 ? max(0, q - window + 1) : 0;
  }
  __device__ __forceinline__ int hi(int q) const {
    return causal ? min(q, Sk - 1) : Sk - 1;
  }
};

// the problem, as the C entry points receive it
struct Prob {
  int B, Hq, Hkv, D;
  Masks mk;
  float scale;
  bool vec;   // every pointer and stride fit 16-byte copies
  __host__ __device__ int group() const { return Hq / Hkv; }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage `rows` rows of DM columns (row r of global memory at g + r * ss)
// into shared memory at sm with a pitch of PITCH elements.  Rows at or
// past `valid` and columns at or past D are zero, so every element a
// kernel reads is defined.  vec: 16-byte cp.async copies (D * sizeof(T) a
// multiple of 16, g and ss aligned); else plain loads.  Threads t of nt
// share the work; the caller commits and waits.
template <typename T, int DM, int PITCH>
__device__ __forceinline__ void load_rows(T* sm, const T* g, long long ss,
                                          int rows, int valid, int D,
                                          bool vec, int t, int nt) {
  if (vec) {
    constexpr int CH = 16 / sizeof(T), CPR = DM / CH;
    const int dch = D / CH;
    for (int e = t; e < rows * CPR; e += nt) {
      const int r = e / CPR, c = e % CPR;
      T* dst = sm + r * PITCH + c * CH;
      if (r < valid && c < dch)
        cp_async16(dst, g + r * ss + c * CH);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = t; e < rows * DM; e += nt) {
      const int r = e / DM, d = e % DM;
      sm[r * PITCH + d] = (r < valid && d < D) ? g[r * ss + d]
                                               : from_f<T>(0.f);
    }
  }
}

// whether every pointer, every stride and a row of D elements of esize
// bytes are multiples of 16 bytes: the condition of the 16-byte copies
inline bool aligned16(const void* const* ptrs, int n, const long long* str,
                      int ns, int D, int esize) {
  if ((D * esize) % 16 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (((uintptr_t)ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < ns; ++i)
    if ((str[i] * esize) % 16 != 0) return false;
  return true;
}

// blocks of `kernel` for a persistent grid: the SMs of the current device
// times the blocks that fit on one, after raising the kernel's dynamic
// shared memory limit.  `cache` holds one entry per device (the caller's,
// one per kernel instance).  0 on a failed query.
template <typename K>
inline int persistent_blocks(K kernel, int threads, int smem, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 16 && cache[dev] > 0) return cache[dev];
  if ((smem > 48 * 1024 &&
       cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem) != cudaSuccess) ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared) !=
          cudaSuccess)
    return 0;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    return 0;
  if (dev < 16) cache[dev] = sms * per_sm;
  return sms * per_sm;
}

}  // namespace fa
