// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (`flash_attention_bhsd` :67, pallas_call at :81; body `_kernel` :27; its
// oracle is flash_attention/ref.py).  For q [BH, Sq, D] and k, v
// [BHkv, Sk, D], query row bh reading KV row bh / group (GQA):
//
//   o = softmax(mask((q / sqrt(D)) k^T)) v
//
// with f32 accumulation, masked logits set to the FINITE -1e30 (so a row
// that sees no key gets the plain mean of v, as the TPU kernel and the
// oracle do), and the output divided by max(l, 1e-30).  Masks, with both
// positions counted from 0 (top-left alignment, also when Sq != Sk):
// causal keeps k_pos <= q_pos; a sliding window keeps k_pos > q_pos -
// window.  The TPU kernel had no backward (its causal loop runs to a
// traced bound, so JAX cannot reverse-differentiate it); this file adds
// one in FA2 style, with no atomics:
//
//   1. delta = rowsum(dO * O)                       one pass over rows
//   2. dK, dV: one block per (KV row, tile of 32 keys), looping over
//      every query head of its GQA group and the query rows that see the
//      tile (and the rows that see no key, whose p is 1/Sk on every key)
//   3. dQ: one block per (q row bh, tile of 32 query rows)
//
// with p = exp(s - L) recomputed from the forward's row log-sum-exp L.
//
// Bound: on the transformer path (BH = 128 P, S = 32, D = 32, causal)
// each (bh) problem is 32x32x32: the forward does 4 D flops for each of
// the S (S + 1) / 2 kept pairs against 4 S D floats moved, ~4 flops a
// byte, far below the ridge of 67 TFLOP/s over 3.35 TB/s (20 flops a
// byte), so the kernels are memory-bound (and launch-bound at small BH).
//
// Design (simple first, no tensor cores): a block of 128 threads holds 32
// rows (queries, or keys for dK/dV), 4 threads per row, each owning the
// dims d = c + 4 t of its row in registers; a row's dot product is a
// per-thread partial sum plus two xor shuffles.  The other operand
// streams through shared memory in tiles of 32 rows, in f32.  The
// forward's online softmax keeps m, l and the accumulator per row in
// f32 and rescales once per tile.  Key and query ranges are cut to the
// rows and keys that can see each other, per block.  Keys past Sk are
// left out entirely (not masked), so the mean of a row that sees no key
// runs over exactly Sk keys.  D up to 128, in three register layouts
// (D <= 32, 64, 128); f32 and bf16 storage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                 // rows per block
constexpr int kTPR = 4;                   // threads per row
constexpr int kThreads = kRows * kTPR;    // 128
constexpr int kTile = 32;                 // rows per staged tile
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

// sum over the 4 threads of one row (adjacent lanes)
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v;
}

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

// Forward: one block per (bh, 32 query rows).
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, Masks mk, int D, int group,
              float scale) {
  constexpr int DM = 32 * DC, kPer = DM / kTPR;
  __shared__ float Ks[kTile][DM];
  __shared__ float Vs[kTile][DM];
  const int Sq = mk.Sq, Sk = mk.Sk;
  const int bh = blockIdx.x, bhk = bh / group;
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, c = tid % kTPR;
  const int qp = q0 + tid / kTPR;
  const bool row_ok = qp < Sq;

  float qr[kPer], acc[kPer];
  const T* qrow = q + ((size_t)bh * Sq + (row_ok ? qp : 0)) * D;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int d = c + kTPR * t;
    qr[t] = (row_ok && d < D) ? to_f(qrow[d]) * scale : 0.f;
    acc[t] = 0.f;
  }
  float m = kMasked, l = 0.f;
  const int lo = mk.lo(qp), hi = mk.hi(qp);

  // keys this block needs: every key when one of its rows sees none
  // (emptiness grows with q, so the last row tells), else the union of
  // the rows' ranges (lo and hi grow with q)
  const int qlast = min(q0 + kRows, Sq) - 1;
  int kb = mk.lo(q0), ke = mk.hi(qlast) + 1;
  if (mk.lo(qlast) > mk.hi(qlast)) { kb = 0; ke = Sk; }

  const T* kbase = k + (size_t)bhk * Sk * D;
  const T* vbase = v + (size_t)bhk * Sk * D;
  for (int kt = kb; kt < ke; kt += kTile) {
    __syncthreads();
    for (int e = tid; e < kTile * DM; e += kThreads) {
      const int j = e / DM, d = e % DM, kp = kt + j;
      const bool ok = kp < Sk && d < D;
      const size_t off = (size_t)kp * D + d;
      Ks[j][d] = ok ? to_f(kbase[off]) : 0.f;
      Vs[j][d] = ok ? to_f(vbase[off]) : 0.f;
    }
    __syncthreads();
    float s[kTile];
    float mt = kMasked;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float p = 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) p += qr[t] * Ks[j][c + kTPR * t];
      p = row_sum(p);
      const int kp = kt + j;
      // keys past Sk are not keys: -inf never wins the max and gives
      // p = 0; keys inside Sk but masked take the finite -1e30
      s[j] = kp < Sk ? ((kp >= lo && kp <= hi) ? p : kMasked) : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) acc[t] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = expf(s[j] - m_new);
      ls += p;
#pragma unroll
      for (int t = 0; t < kPer; ++t) acc[t] += p * Vs[j][c + kTPR * t];
    }
    l = l * alpha + ls;
    m = m_new;
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + ((size_t)bh * Sq + qp) * D;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int d = c + kTPR * t;
      if (d < D) orow[d] = from_f<T>(acc[t] / den);
    }
    if (c == 0) lse[(size_t)bh * Sq + qp] = m + logf(l);
  }
}

// Backward pass 1: delta[row] = sum_d dO * O, 32 rows a block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / kTPR;
  const int c = threadIdx.x % kTPR;
  float a = 0.f;
  if (row < rows) {
    const T* orow = o + row * D;
    const T* grow = dout + row * D;
    for (int d = c; d < D; d += kTPR) a += to_f(orow[d]) * to_f(grow[d]);
  }
  a = row_sum(a);
  if (row < rows && c == 0) delta[row] = a;
}

// Backward pass 2: dK and dV, one block per (KV row, 32 keys).
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Masks mk, int D, int group,
                   float scale) {
  constexpr int DM = 32 * DC, kPer = DM / kTPR;
  __shared__ float Qs[kTile][DM];     // q * scale
  __shared__ float Gs[kTile][DM];     // dO
  __shared__ float Ls[kTile], Ds[kTile];
  const int Sq = mk.Sq, Sk = mk.Sk;
  const int bhk = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, c = tid % kTPR;
  const int kp = k0 + tid / kTPR;
  const bool key_ok = kp < Sk;
  const float inv_sk = 1.f / (float)Sk;

  float kr[kPer], vr[kPer], dka[kPer], dva[kPer];
  const size_t koff = ((size_t)bhk * Sk + (key_ok ? kp : 0)) * D;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int d = c + kTPR * t;
    kr[t] = (key_ok && d < D) ? to_f(k[koff + d]) : 0.f;
    vr[t] = (key_ok && d < D) ? to_f(v[koff + d]) : 0.f;
    dka[t] = 0.f;
    dva[t] = 0.f;
  }

  // query rows that see a key of [k0, k1): [qa, qb); rows that see no
  // key at all (only with a window): [qe, Sq)
  const int k1 = min(k0 + kRows, Sk);
  const int qa = mk.causal ? k0 : 0;
  const int qb = mk.window > 0 ? min(Sq, k1 - 1 + mk.window) : Sq;
  const int qe = mk.window > 0 ? max(qb, Sk - 1 + mk.window) : Sq;
  const int starts[2] = {qa, qe}, ends[2] = {qb, Sq};

  for (int h = 0; h < group; ++h) {
    const size_t bh = (size_t)bhk * group + h;
    for (int r = 0; r < 2; ++r) {
      for (int qt = starts[r]; qt < ends[r]; qt += kTile) {
        const int n = min(kTile, ends[r] - qt);
        __syncthreads();
        for (int e = tid; e < kTile * DM; e += kThreads) {
          const int i = e / DM, d = e % DM;
          const bool ok = i < n && d < D;
          const size_t off = (bh * Sq + qt + i) * D + d;
          Qs[i][d] = ok ? to_f(q[off]) * scale : 0.f;
          Gs[i][d] = ok ? to_f(dout[off]) : 0.f;
        }
        if (tid < kTile) {
          const bool ok = tid < n;
          Ls[tid] = ok ? lse[bh * Sq + qt + tid] : 0.f;
          Ds[tid] = ok ? delta[bh * Sq + qt + tid] : 0.f;
        }
        __syncthreads();
        for (int i = 0; i < n; ++i) {
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int t = 0; t < kPer; ++t) {
            s += Qs[i][c + kTPR * t] * kr[t];
            dp += Gs[i][c + kTPR * t] * vr[t];
          }
          s = row_sum(s);
          dp = row_sum(dp);
          const int qp = qt + i;
          const int lo = mk.lo(qp), hi = mk.hi(qp);
          const bool valid = key_ok && kp >= lo && kp <= hi;
          const float p = lo > hi ? inv_sk : (valid ? expf(s - Ls[i]) : 0.f);
          const float ds = valid ? p * (dp - Ds[i]) : 0.f;
#pragma unroll
          for (int t = 0; t < kPer; ++t) {
            dva[t] += p * Gs[i][c + kTPR * t];
            dka[t] += ds * Qs[i][c + kTPR * t];
          }
        }
      }
    }
  }

  if (key_ok) {
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int d = c + kTPR * t;
      if (d < D) {
        dk[koff + d] = from_f<T>(dka[t]);
        dv[koff + d] = from_f<T>(dva[t]);
      }
    }
  }
}

// Backward pass 3: dQ, one block per (bh, 32 query rows).  A row that
// sees no key has dQ = 0: its logits are the constant -1e30.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 Masks mk, int D, int group, float scale) {
  constexpr int DM = 32 * DC, kPer = DM / kTPR;
  __shared__ float Ks[kTile][DM];
  __shared__ float Vs[kTile][DM];
  const int Sq = mk.Sq, Sk = mk.Sk;
  const int bh = blockIdx.x, bhk = bh / group;
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, c = tid % kTPR;
  const int qp = q0 + tid / kTPR;
  const bool row_ok = qp < Sq;

  float qr[kPer], gr[kPer], dqa[kPer];
  const size_t qoff = ((size_t)bh * Sq + (row_ok ? qp : 0)) * D;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int d = c + kTPR * t;
    qr[t] = (row_ok && d < D) ? to_f(q[qoff + d]) * scale : 0.f;
    gr[t] = (row_ok && d < D) ? to_f(dout[qoff + d]) : 0.f;
    dqa[t] = 0.f;
  }
  const float L = row_ok ? lse[(size_t)bh * Sq + qp] : 0.f;
  const float Dl = row_ok ? delta[(size_t)bh * Sq + qp] : 0.f;
  const int lo = mk.lo(qp), hi = mk.hi(qp);
  const int qlast = min(q0 + kRows, Sq) - 1;
  const int kb = mk.lo(q0), ke = mk.hi(qlast) + 1;

  const T* kbase = k + (size_t)bhk * Sk * D;
  const T* vbase = v + (size_t)bhk * Sk * D;
  for (int kt = kb; kt < ke; kt += kTile) {
    __syncthreads();
    for (int e = tid; e < kTile * DM; e += kThreads) {
      const int j = e / DM, d = e % DM, kp = kt + j;
      const bool ok = kp < Sk && d < D;
      const size_t off = (size_t)kp * D + d;
      Ks[j][d] = ok ? to_f(kbase[off]) : 0.f;
      Vs[j][d] = ok ? to_f(vbase[off]) : 0.f;
    }
    __syncthreads();
    const int n = min(kTile, Sk - kt);
    for (int j = 0; j < n; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        s += qr[t] * Ks[j][c + kTPR * t];
        dp += gr[t] * Vs[j][c + kTPR * t];
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int kp = kt + j;
      const float ds = (kp >= lo && kp <= hi) ? expf(s - L) * (dp - Dl)
                                              : 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) dqa[t] += ds * Ks[j][c + kTPR * t];
    }
  }

  if (row_ok) {
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int d = c + kTPR * t;
      if (d < D) dq[qoff + d] = from_f<T>(dqa[t] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  float *lse, *delta;
  void *out, *dq, *dk, *dv;
  int BH, BHkv, D;
  Masks mk;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DC>
int fwd(const Args& a) {
  dim3 grid((unsigned)a.BH, (unsigned)((a.mk.Sq + kRows - 1) / kRows));
  fa_fwd_kernel<T, DC><<<grid, kThreads, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.lse, a.mk,
      a.D, a.BH / a.BHkv, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int DC>
int bwd(const Args& a) {
  const long long rows = (long long)a.BH * a.mk.Sq;
  fa_bwd_delta_kernel<T><<<(unsigned)((rows + kRows - 1) / kRows), kThreads,
                           0, a.stream>>>(
      (const T*)a.o, (const T*)a.dout, a.delta, rows, a.D);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int group = a.BH / a.BHkv;
  dim3 gk((unsigned)a.BHkv, (unsigned)((a.mk.Sk + kRows - 1) / kRows));
  fa_bwd_dkdv_kernel<T, DC><<<gk, kThreads, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dk, (T*)a.dv, a.mk, a.D, group, a.scale);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dim3 gq((unsigned)a.BH, (unsigned)((a.mk.Sq + kRows - 1) / kRows));
  fa_bwd_dq_kernel<T, DC><<<gq, kThreads, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dq, a.mk, a.D, group, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int DC> struct Fwd {
  static int run(const Args& a) { return fwd<T, DC>(a); }
};
template <typename T, int DC> struct Bwd {
  static int run(const Args& a) { return bwd<T, DC>(a); }
};

// pick the register layout for D, and the storage type
template <template <typename, int> class F, typename T>
int by_d(const Args& a) {
  if (a.D <= 32) return F<T, 1>::run(a);
  if (a.D <= 64) return F<T, 2>::run(a);
  if (a.D <= 128) return F<T, 4>::run(a);
  return (int)cudaErrorInvalidValue;
}

template <template <typename, int> class F>
int dispatch(const Args& a, int dtype) {
  if (a.BH == 0 || a.mk.Sq == 0) return 0;
  if (a.D <= 0 || a.mk.Sk <= 0 || a.BHkv <= 0 || a.BH % a.BHkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return by_d<F, float>(a);
  if (dtype == 1) return by_d<F, __nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points for ctypes.  dtype: 0 = float32, 1 = bfloat16; causal is
// 0 or 1; window 0 means none.  Each launches on `stream` (PyTorch's
// current stream) on the current device, which the caller sets; changes
// no device state, does not synchronise, allocates nothing (the caller
// passes lse and the delta scratch); returns the cudaError_t of its
// launches (0 = cudaSuccess).

extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int BH, int BHkv, int Sq, int Sk, int D, int causal, int window,
    float scale, int dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, lse, nullptr, o, nullptr, nullptr,
         nullptr, BH, BHkv, D, Masks{Sq, Sk, causal, window}, scale,
         (cudaStream_t)stream};
  return dispatch<Fwd>(a, dtype);
}

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int BH, int BHkv, int Sq, int Sk, int D, int causal,
    int window, float scale, int dtype, void* stream) {
  Args a{q, k, v, o, dout, (float*)lse, delta, nullptr, dq, dk, dv, BH,
         BHkv, D, Masks{Sq, Sk, causal, window}, scale,
         (cudaStream_t)stream};
  return dispatch<Bwd>(a, dtype);
}
