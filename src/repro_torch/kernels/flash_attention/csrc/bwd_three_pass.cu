// Flash attention backward for long sequences, in three passes, for
// Hopper (sm_90a): the FA2-style kernels of the first port, now reading
// and writing through strides (common.cuh).  The wrapper takes them where
// bwd_fused.cu's whole-head tiles do not fit in shared memory.
//
// The TPU kernel (src/repro/kernels/flash_attention/flash_attention.py,
// `flash_attention_bhsd` :67) had no backward.  With p = exp(s - L)
// recomputed from the forward's row log-sum-exp L, no atomics:
//
//   1. delta = rowsum(dO * O)                       one pass over rows
//   2. dK, dV: one block per (KV head, tile of 32 keys), looping over
//      every query head of its GQA group and the query rows that see the
//      tile (and the rows that see no key, whose p is 1/Sk on every key)
//   3. dQ: one block per (query head, tile of 32 query rows)
//
// Bound: as bwd_fused.cu's (q, k, v, o, dO, lse in; dq, dk, dv out);
// these passes re-read q, k, v, dO, lse and delta and compute s and p
// twice.  A block of 128 threads holds 32 rows, 4 threads a row, each
// owning the dims d = c + 4 t of its row in registers; the other operand
// streams through shared memory in tiles of 32 rows, in f32.  D up to
// 128, in three register layouts (D <= 32, 64, 128).

#include "common.cuh"

namespace fa {
namespace {

constexpr int kRows = 32;                 // rows per block
constexpr int kTPR = 4;                   // threads per row
constexpr int kThreads = kRows * kTPR;    // 128
constexpr int kTile = 32;                 // rows per staged tile

// sum over the 4 threads of one row (adjacent lanes)
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v;
}

struct Lays { Lay q, k, v, o, g, dq, dk, dv; };

// Pass 1: delta[row] = sum_d dO * O, 32 rows a block; row = bh * Sq + i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, Lays L, Prob p) {
  const long long rows = (long long)p.B * p.Hq * p.mk.Sq;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / kTPR;
  const int c = threadIdx.x % kTPR;
  float a = 0.f;
  if (row < rows) {
    const int bh = (int)(row / p.mk.Sq), i = (int)(row % p.mk.Sq);
    const int b = bh / p.Hq, h = bh % p.Hq;
    const T* orow = o + L.o.at(b, h, i);
    const T* grow = dout + L.g.at(b, h, i);
    for (int d = c; d < p.D; d += kTPR) a += to_f(orow[d]) * to_f(grow[d]);
  }
  a = row_sum(a);
  if (row < rows && c == 0) delta[row] = a;
}

// Pass 2: dK and dV, one block per (KV head, 32 keys).
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Lays L, Prob p) {
  constexpr int DM = 32 * DC, kPer = DM / kTPR;
  __shared__ float Qs[kTile][DM];     // q * scale
  __shared__ float Gs[kTile][DM];     // dO
  __shared__ float Ls[kTile], Ds[kTile];
  const Masks mk = p.mk;
  const int Sq = mk.Sq, Sk = mk.Sk, D = p.D, group = p.group();
  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, c = tid % kTPR;
  const int kp = k0 + tid / kTPR;
  const bool key_ok = kp < Sk;
  const float inv_sk = 1.f / (float)Sk;

  float kr[kPer], vr[kPer], dka[kPer], dva[kPer];
  const T* krow = k + L.k.at(b, hk, key_ok ? kp : 0);
  const T* vrow = v + L.v.at(b, hk, key_ok ? kp : 0);
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int d = c + kTPR * t;
    kr[t] = (key_ok && d < D) ? to_f(krow[d]) : 0.f;
    vr[t] = (key_ok && d < D) ? to_f(vrow[d]) : 0.f;
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

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const long long bh = (long long)b * p.Hq + h;
    for (int r = 0; r < 2; ++r) {
      for (int qt = starts[r]; qt < ends[r]; qt += kTile) {
        const int n = min(kTile, ends[r] - qt);
        __syncthreads();
        for (int e = tid; e < kTile * DM; e += kThreads) {
          const int i = e / DM, d = e % DM;
          const bool ok = i < n && d < D;
          Qs[i][d] = ok ? to_f(q[L.q.at(b, h, qt + i) + d]) * p.scale : 0.f;
          Gs[i][d] = ok ? to_f(dout[L.g.at(b, h, qt + i) + d]) : 0.f;
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
          const float pr = lo > hi ? inv_sk : (valid ? expf(s - Ls[i]) : 0.f);
          const float ds = valid ? pr * (dp - Ds[i]) : 0.f;
#pragma unroll
          for (int t = 0; t < kPer; ++t) {
            dva[t] += pr * Gs[i][c + kTPR * t];
            dka[t] += ds * Qs[i][c + kTPR * t];
          }
        }
      }
    }
  }

  if (key_ok) {
    T* dkrow = dk + L.dk.at(b, hk, kp);
    T* dvrow = dv + L.dv.at(b, hk, kp);
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int d = c + kTPR * t;
      if (d < D) {
        dkrow[d] = from_f<T>(dka[t]);
        dvrow[d] = from_f<T>(dva[t]);
      }
    }
  }
}

// Pass 3: dQ, one block per (query head, 32 query rows).  A row that
// sees no key has dQ = 0: its logits are the constant -1e30.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 Lays L, Prob p) {
  constexpr int DM = 32 * DC, kPer = DM / kTPR;
  __shared__ float Ks[kTile][DM];
  __shared__ float Vs[kTile][DM];
  const Masks mk = p.mk;
  const int Sq = mk.Sq, Sk = mk.Sk, D = p.D;
  const int bh = blockIdx.x, b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / p.group();
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, c = tid % kTPR;
  const int qp = q0 + tid / kTPR;
  const bool row_ok = qp < Sq;

  float qr[kPer], gr[kPer], dqa[kPer];
  const T* qrow = q + L.q.at(b, h, row_ok ? qp : 0);
  const T* grow = dout + L.g.at(b, h, row_ok ? qp : 0);
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int d = c + kTPR * t;
    qr[t] = (row_ok && d < D) ? to_f(qrow[d]) * p.scale : 0.f;
    gr[t] = (row_ok && d < D) ? to_f(grow[d]) : 0.f;
    dqa[t] = 0.f;
  }
  const long long lrow = (long long)bh * Sq + (row_ok ? qp : 0);
  const float Lq = row_ok ? lse[lrow] : 0.f;
  const float Dl = row_ok ? delta[lrow] : 0.f;
  const int lo = mk.lo(qp), hi = mk.hi(qp);
  const int qlast = min(q0 + kRows, Sq) - 1;
  const int kb = mk.lo(q0), ke = mk.hi(qlast) + 1;

  for (int kt = kb; kt < ke; kt += kTile) {
    __syncthreads();
    for (int e = tid; e < kTile * DM; e += kThreads) {
      const int j = e / DM, d = e % DM, kp = kt + j;
      const bool ok = kp < Sk && d < D;
      Ks[j][d] = ok ? to_f(k[L.k.at(b, hk, kp) + d]) : 0.f;
      Vs[j][d] = ok ? to_f(v[L.v.at(b, hk, kp) + d]) : 0.f;
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
      const float ds = (kp >= lo && kp <= hi) ? expf(s - Lq) * (dp - Dl)
                                              : 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) dqa[t] += ds * Ks[j][c + kTPR * t];
    }
  }

  if (row_ok) {
    T* dqrow = dq + L.dq.at(b, h, qp);
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int d = c + kTPR * t;
      if (d < D) dqrow[d] = from_f<T>(dqa[t] * p.scale);
    }
  }
}

template <typename T, int DC>
int run(const void* const* ptr, float* delta, const Lays& L, const Prob& p,
        cudaStream_t stream) {
  const T *q = (const T*)ptr[0], *k = (const T*)ptr[1], *v = (const T*)ptr[2];
  const T *o = (const T*)ptr[3], *g = (const T*)ptr[4];
  const float* lse = (const float*)ptr[5];
  const int Sq = p.mk.Sq, Sk = p.mk.Sk;
  const long long rows = (long long)p.B * p.Hq * Sq;
  fa_bwd_delta_kernel<T><<<(unsigned)((rows + kRows - 1) / kRows), kThreads,
                           0, stream>>>(o, g, delta, L, p);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dim3 gk((unsigned)(p.B * p.Hkv), (unsigned)((Sk + kRows - 1) / kRows));
  fa_bwd_dkdv_kernel<T, DC><<<gk, kThreads, 0, stream>>>(
      q, k, v, g, lse, delta, (T*)ptr[7], (T*)ptr[8], L, p);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dim3 gq((unsigned)(p.B * p.Hq), (unsigned)((Sq + kRows - 1) / kRows));
  fa_bwd_dq_kernel<T, DC><<<gq, kThreads, 0, stream>>>(
      q, k, v, g, lse, delta, (T*)ptr[6], L, p);
  return (int)cudaGetLastError();
}

template <typename T>
int by_d(const void* const* ptr, float* delta, const Lays& L, const Prob& p,
         cudaStream_t s) {
  if (p.D <= 32) return run<T, 1>(ptr, delta, L, p, s);
  if (p.D <= 64) return run<T, 2>(ptr, delta, L, p, s);
  if (p.D <= 128) return run<T, 4>(ptr, delta, L, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fa

// C entry point for ctypes: as flash_attention_bwd_fused_launch, with the
// caller's delta scratch ([B * Hq, Sq] f32).  Three launches on `stream`;
// returns the first non-zero cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const long long* strides, int B, int Hq, int Hkv, int Sq,
    int Sk, int D, int causal, int window, float scale, int dtype,
    void* stream) {
  using namespace fa;
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (D <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  Lay l[8];
  for (int i = 0; i < 8; ++i)
    l[i] = Lay{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Lays L{l[0], l[1], l[2], l[3], l[4], l[5], l[6], l[7]};
  const void* ptr[9] = {q, k, v, o, dout, lse, dq, dk, dv};
  Prob p{B, Hq, Hkv, D, Masks{Sq, Sk, causal, window}, scale, false};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? by_d<float>(ptr, delta, L, p, s)
                    : by_d<__nv_bfloat16>(ptr, delta, L, p, s);
}
