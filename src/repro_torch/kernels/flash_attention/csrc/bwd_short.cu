// Flash attention backward for short queries over long key sets, split
// over the keys as fwd_split.cu splits them, one launch, for Hopper
// (sm_90a).
//
// The TPU kernel (src/repro/kernels/flash_attention/flash_attention.py,
// `flash_attention_bhsd` :67) had no backward; this is the gradient of
// fwd_split.cu's function (the same as fwd.cu's), for Sq <= 8 query rows
// a head and a GQA group of at most 32 padded rows (group x 4 or 8).
// With p = exp(s - L) from the forward's row log-sum-exp L:
//
//   delta = rowsum(dO * O),  dS = P * (dO V^T - delta),
//   dV = sum over the group's heads of P^T dO,
//   dK = sum over the group's heads of dS^T Q / sqrt(D),
//   dQ = dS K / sqrt(D),
//
// with the forward's semantics: a row that sees no key has p = 1/Sk on
// every key (its dV share) and dS = 0; keys past Sk are not keys.
//
// Bound: bytes: q, k, v, o, dO and lse in, dq, dk and dv out (109.5 MB at
// BH 208, Sk 1024, D 32: 0.0327 ms at 3.35 TB/s); 10 Sq D flops a key.
// bwd_three_pass.cu holds 32 query rows a block (4 live at Sq = 4) and
// gives the dQ pass one block per head, walking every key.
//
// Design: one block is (b, KV head, split s), 4 warps, each warp one tile
// of KT keys (short.cuh): BHkv x ceil(Sk / SPLIT) blocks.  The block
// copies its warps' K and V tiles with 16-byte cp.async while it loads
// the group's rows of q (times 1/sqrt(D)) and dO as floats and computes
// delta itself (no delta pass).  Per query head of the group, each warp:
//   1. lanes own keys: s and dP of the lane's key against every row
//      (broadcast reads of the rows), then P and dS into shared memory;
//   2. lanes own columns: dV += P^T dO and dK += dS^T Q for the warp's
//      keys, held in registers over the group's heads, and the head's
//      partial dQ = dS K over the warp's keys, into shared memory.
// Each key belongs to one warp of one block, which writes its dK and dV
// rows directly.  The warps' dQ partials are summed in warp order into
// the block's partial in the workspace; the last block of the KV head to
// arrive (an integer ticket) sums the splits' partials in split order
// and writes dQ.  No float atomics: two launches give the same bits.  A
// block stores its partial and takes the ticket before it writes its dK
// and dV rows, so the ticket's fence waits for the partial alone; at D
// <= 32 and Sq <= 4 (the set mixer) it asks for four blocks an SM, 128
// registers a thread.

#include "short.cuh"

namespace fa {
namespace {

using namespace shortq;

struct Lays { Lay q, k, v, o, g, dq, dk, dv; };

// shared memory: the warps' K and V tiles, then (floats) the group's R
// rows of q * scale and dO (pitch DM + 4), lse and delta [R], each
// warp's P and dS [KT][SQ], each warp's dQ partial [R][DM], a flag
template <typename T, int DM, int SQ>
struct BwdShort : Cfg<T, DM, SQ> {
  using B = Cfg<T, DM, SQ>;
  static constexpr int QP = DM + 4;
  __host__ __device__ static int q_off() { return kWarps * B::WARP_BYTES; }
  __host__ __device__ static int g_off(int R) { return q_off() + R * QP * 4; }
  __host__ __device__ static int l_off(int R) { return g_off(R) + R * QP * 4; }
  __host__ __device__ static int d_off(int R) { return l_off(R) + R * 4; }
  __host__ __device__ static int p_off(int R) { return d_off(R) + R * 4; }
  __host__ __device__ static int s_off(int R) {
    return p_off(R) + kWarps * B::KT * SQ * 4;
  }
  __host__ __device__ static int dq_off(int R) {
    return s_off(R) + kWarps * B::KT * SQ * 4;
  }
  __host__ __device__ static int flag_off(int R) {
    return dq_off(R) + kWarps * R * DM * 4;
  }
  __host__ __device__ static int smem(int R) { return flag_off(R) + 16; }
};

// the set mixer's layout (D 32, 4 rows) asks for four blocks an SM (at
// most 128 registers a thread); the others take what they need
template <typename T, int DM, int SQ>
__global__ void __launch_bounds__(kThreads, DM == 32 && SQ == 4 ? 4 : 1)
fa_bwd_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ part, int* __restrict__ tickets,
                    Lays L, Prob p, int S) {
  using C = BwdShort<T, DM, SQ>;
  constexpr int CPK = C::CPK, KT = C::KT, NU = C::NU, DPL = C::DPL;
  constexpr int PITCH = C::PITCH, QP = C::QP;
  extern __shared__ __align__(16) unsigned char smem[];
  const Masks mk = p.mk;
  const int Sq = mk.Sq, Sk = mk.Sk, D = p.D, G = p.group(), R = G * SQ;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* Ks = reinterpret_cast<T*>(smem + w * C::WARP_BYTES);
  T* Vs = Ks + C::TILE;
  float* Qs = reinterpret_cast<float*>(smem + C::q_off());
  float* Gs = reinterpret_cast<float*>(smem + C::g_off(R));
  float* Ls = reinterpret_cast<float*>(smem + C::l_off(R));
  float* Dl = reinterpret_cast<float*>(smem + C::d_off(R));
  float* Pw = reinterpret_cast<float*>(smem + C::p_off(R)) + w * KT * SQ;
  float* Sw = reinterpret_cast<float*>(smem + C::s_off(R)) + w * KT * SQ;
  float* DQ = reinterpret_cast<float*>(smem + C::dq_off(R));
  int* flag = reinterpret_cast<int*>(smem + C::flag_off(R));
  const int bk = blockIdx.x / S, s = blockIdx.x % S;
  const int b = bk / p.Hkv, hk = bk % p.Hkv;
  const int k0 = s * C::SPLIT + w * KT;
  const int nk = max(0, min(KT, Sk - k0));
  const int kc = nk > 0 ? k0 : 0;

  load_rows<T, DM, PITCH>(Ks, k + L.k.at(b, hk, kc), L.k.ss, KT, nk, D,
                          p.vec, lane, 32);
  load_rows<T, DM, PITCH>(Vs, v + L.v.at(b, hk, kc), L.v.ss, KT, nk, D,
                          p.vec, lane, 32);
  cp_async_commit();
  // the group's rows (row hh * SQ + r is row r of head hk * G + hh; rows
  // r >= Sq and columns d >= D are zero)
  for (int e = threadIdx.x; e < R * DM; e += kThreads) {
    const int row = e / DM, d = e % DM, r = row % SQ;
    const int h = hk * G + row / SQ;
    const bool ok = r < Sq && d < D;
    Qs[row * QP + d] = ok ? to_f(q[L.q.at(b, h, r) + d]) * p.scale : 0.f;
    Gs[row * QP + d] = ok ? to_f(dout[L.g.at(b, h, r) + d]) : 0.f;
  }
  for (int row = w; row < R; row += kWarps) {
    const int r = row % SQ, h = hk * G + row / SQ;
    float a = 0.f;
    if (r < Sq) {
      const T* orow = o + L.o.at(b, h, r);
      const T* grow = dout + L.g.at(b, h, r);
      for (int d = lane; d < D; d += 32) a += to_f(orow[d]) * to_f(grow[d]);
    }
    a = warp_sum(a);
    if (lane == 0) {
      Dl[row] = a;
      Ls[row] = r < Sq ? lse[((long long)b * p.Hq + h) * Sq + r] : 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int j = lane / CPK, c = lane % CPK, kp = k0 + j;
  const bool valid = j < nk;
  const float inv_sk = 1.f / (float)Sk;
  float dka[KT][DPL], dva[KT][DPL];
#pragma unroll
  for (int jj = 0; jj < KT; ++jj)
#pragma unroll
    for (int e = 0; e < DPL; ++e) dka[jj][e] = dva[jj][e] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const float* Qh = Qs + hh * SQ * QP;
    const float* Gh = Gs + hh * SQ * QP;
    // 1. s and dP of the lane's key (its column chunk c) against every row
    float sc[SQ], dp[SQ];
#pragma unroll
    for (int r = 0; r < SQ; ++r) sc[r] = dp[r] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int col = 4 * (u * CPK + c);
      float kx[4], vx[4];
      ld4(Ks + j * PITCH + col, kx);
      ld4(Vs + j * PITCH + col, vx);
#pragma unroll
      for (int r = 0; r < SQ; ++r) {
        float qx[4], gx[4];
        ld4(Qh + r * QP + col, qx);
        ld4(Gh + r * QP + col, gx);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          sc[r] = fmaf(qx[x], kx[x], sc[r]);
          dp[r] = fmaf(gx[x], vx[x], dp[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < SQ; ++r) {
      sc[r] = key_sum<CPK>(sc[r]);
      dp[r] = key_sum<CPK>(dp[r]);
      const int lo = mk.lo(r), hi = mk.hi(r);
      const bool vis = valid && r < Sq && kp >= lo && kp <= hi;
      const float pr = (!valid || r >= Sq) ? 0.f
                       : lo > hi          ? inv_sk
                       : vis ? expf(sc[r] - Ls[hh * SQ + r]) : 0.f;
      dp[r] = vis ? pr * (dp[r] - Dl[hh * SQ + r]) : 0.f;
      sc[r] = pr;
    }
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < SQ; r += 4) {
        *reinterpret_cast<float4*>(Pw + j * SQ + r) =
            make_float4(sc[r], sc[r + 1], sc[r + 2], sc[r + 3]);
        *reinterpret_cast<float4*>(Sw + j * SQ + r) =
            make_float4(dp[r], dp[r + 1], dp[r + 2], dp[r + 3]);
      }
    }
    __syncwarp();

    // 2. lanes own columns lane * DPL ..: dV, dK over the warp's keys,
    // the head's dQ partial over them
    float qh[SQ][DPL], gh[SQ][DPL], dqa[SQ][DPL];
#pragma unroll
    for (int r = 0; r < SQ; ++r) {
      ld_n<DPL>(Qh + r * QP + lane * DPL, qh[r]);
      ld_n<DPL>(Gh + r * QP + lane * DPL, gh[r]);
#pragma unroll
      for (int e = 0; e < DPL; ++e) dqa[r][e] = 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      float pj[SQ], dsj[SQ], kx[DPL];
#pragma unroll
      for (int r = 0; r < SQ; r += 4) {
        const float4 a = *reinterpret_cast<const float4*>(Pw + jj * SQ + r);
        const float4 z = *reinterpret_cast<const float4*>(Sw + jj * SQ + r);
        pj[r] = a.x; pj[r + 1] = a.y; pj[r + 2] = a.z; pj[r + 3] = a.w;
        dsj[r] = z.x; dsj[r + 1] = z.y; dsj[r + 2] = z.z; dsj[r + 3] = z.w;
      }
      ld_n<DPL>(Ks + jj * PITCH + lane * DPL, kx);
#pragma unroll
      for (int r = 0; r < SQ; ++r)
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          dva[jj][e] = fmaf(pj[r], gh[r][e], dva[jj][e]);
          dka[jj][e] = fmaf(dsj[r], qh[r][e], dka[jj][e]);
          dqa[r][e] = fmaf(dsj[r], kx[e], dqa[r][e]);
        }
    }
    float* dqw = DQ + (w * R + hh * SQ) * DM + lane * DPL;
#pragma unroll
    for (int r = 0; r < SQ; ++r)
#pragma unroll
      for (int e = 0; e < DPL; ++e) dqw[r * DM + e] = dqa[r][e];
    __syncwarp();
  }

  __syncthreads();

  // the block's dQ partial: the warps' summed in warp order; stored and
  // the ticket taken before the dK and dV rows, so the ticket's fence
  // waits only for the partial
  const int per = G * Sq * D;
  float* pb = part + ((long long)bk * S + s) * per;
  for (int e = threadIdx.x; e < per; e += kThreads) {
    const int hh = e / (Sq * D), r = (e / D) % Sq, d = e % D;
    const float* src = DQ + (hh * SQ + r) * DM + d;
    float a = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) a += src[ww * R * DM];
    pb[e] = a;
  }
  const bool last = last_block(tickets + bk, S, flag);

  // the warp's dK and dV rows
#pragma unroll
  for (int jj = 0; jj < KT; ++jj) {
    if (jj < nk) {
      T* dkr = dk + L.dk.at(b, hk, k0 + jj);
      T* dvr = dv + L.dv.at(b, hk, k0 + jj);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane * DPL + e;
        if (d < D) {
          dkr[d] = from_f<T>(dka[jj][e]);
          dvr[d] = from_f<T>(dva[jj][e]);
        }
      }
    }
  }
  if (!last) return;

  // the last block of the KV head: the splits' partials in split order,
  // read 2 kBatch splits at a time (one value a split)
  const float* pr0 = part + (long long)bk * S * per;
  for (int e = threadIdx.x; e < per; e += kThreads) {
    const int hh = e / (Sq * D), r = (e / D) % Sq, d = e % D;
    float a = 0.f;
    for (int t0 = 0; t0 < S; t0 += 2 * kBatch) {
      float x[2 * kBatch];
#pragma unroll
      for (int i = 0; i < 2 * kBatch; ++i)
        x[i] = __ldcg(pr0 + (long long)min(t0 + i, S - 1) * per + e);
#pragma unroll
      for (int i = 0; i < 2 * kBatch; ++i)
        if (t0 + i < S) a += x[i];
    }
    dq[L.dq.at(b, hk * G + hh, r) + d] = from_f<T>(a * p.scale);
  }
}

template <typename T, int DM, int SQ>
int run(const void* const* ptr, float* part, int* tickets, const Lays& L,
        const Prob& p, int S, cudaStream_t stream) {
  using C = BwdShort<T, DM, SQ>;
  static int done[16] = {0};
  const int smem = C::smem(p.group() * SQ);
  if (!allow_smem(fa_bwd_short_kernel<T, DM, SQ>, smem, done))
    return (int)cudaErrorInvalidConfiguration;
  const long long grid = (long long)p.B * p.Hkv * S;
  fa_bwd_short_kernel<T, DM, SQ><<<(unsigned)grid, kThreads, smem, stream>>>(
      (const T*)ptr[0], (const T*)ptr[1], (const T*)ptr[2],
      (const T*)ptr[3], (const T*)ptr[4], (const float*)ptr[5], (T*)ptr[6],
      (T*)ptr[7], (T*)ptr[8], part, tickets, L, p, S);
  return (int)cudaGetLastError();
}

template <typename T, int DM>
int by_sq(const void* const* ptr, float* part, int* tickets, const Lays& L,
          const Prob& p, int S, cudaStream_t s) {
  if (p.mk.Sq <= 4) return run<T, DM, 4>(ptr, part, tickets, L, p, S, s);
  return run<T, DM, 8>(ptr, part, tickets, L, p, S, s);
}

template <typename T>
int by_d(const void* const* ptr, float* part, int* tickets, const Lays& L,
         const Prob& p, int S, cudaStream_t s) {
  if (p.D <= 32) return by_sq<T, 32>(ptr, part, tickets, L, p, S, s);
  if (p.D <= 64) return by_sq<T, 64>(ptr, part, tickets, L, p, S, s);
  return by_sq<T, 128>(ptr, part, tickets, L, p, S, s);
}

}  // namespace
}  // namespace fa

// C entry point for ctypes: as flash_attention_bwd_fused_launch, with the
// split (keys a block; refused unless it is short.cuh's split_for(D), the
// wrapper's route function's), the dQ partials' workspace (f32,
// [B * Hq, ceil(Sk / split), Sq, D]) and the tickets (B * Hkv ints, 0
// before the call and put back to 0 by it).  Refuses Sq > 8, D > 128 and
// a GQA group of more than 32 padded rows with cudaErrorInvalidValue.
// One launch.
extern "C" int flash_attention_bwd_short_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* part, int* tickets, const long long* strides, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, int causal, int window, float scale,
    int dtype, int split, void* stream) {
  using namespace fa;
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (D <= 0 || D > 128 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Sq > shortq::kMaxSq || dtype < 0 || dtype > 1 ||
      (Hq / Hkv) * shortq::padded_sq(Sq) > shortq::kMaxRows ||
      split != shortq::split_for(D))
    return (int)cudaErrorInvalidValue;
  const long long S = ((long long)Sk + split - 1) / split;
  if ((long long)B * Hkv * S >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Lay l[8];
  for (int i = 0; i < 8; ++i)
    l[i] = Lay{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Lays L{l[0], l[1], l[2], l[3], l[4], l[5], l[6], l[7]};
  const void* ptr[9] = {q, k, v, o, dout, lse, dq, dk, dv};
  // the 16-byte copies read only k and v
  const void* kv[2] = {k, v};
  const int esize = dtype == 0 ? 4 : 2;
  Prob p{B, Hq, Hkv, D, Masks{Sq, Sk, causal, window}, scale,
         aligned16(kv, 2, strides + 3, 6, D, esize)};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? by_d<float>(ptr, part, tickets, L, p, (int)S, s)
             : by_d<__nv_bfloat16>(ptr, part, tickets, L, p, (int)S, s);
}
