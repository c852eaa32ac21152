// Flash attention forward for short queries over long key sets, split
// over the keys (flash-decoding), for Hopper (sm_90a).
//
// Replaces, for Sq <= 8 query rows a head, the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (`flash_attention_bhsd` :67, pallas_call at :81; body `_kernel` :27),
// with fwd.cu's contract: o = softmax(mask((q / sqrt(D)) k^T)) v and the
// row log-sum-exp, f32 accumulation, masked logits at the finite -1e30
// (a row that sees no key gets the plain mean of v over exactly Sk keys;
// keys past Sk are not keys), causal and window masks aligned top-left,
// GQA, D <= 128, f32 or bf16, any (batch, head, position) strides.  The
// wrapper's route function takes this kernel by shape alone; the set
// mixer's pooling (4 seed queries over up to 4096 stored agents, D 32) is
// the shape it was made for.
//
// Bound: bytes.  K and V are 99.6% of them at the set mixer's shapes (q,
// k, v in, o and lse out: 54.7 MB at BH 208, Sk 1024, D 32, 0.0163 ms at
// 3.35 TB/s); 4 Sq D flops a key, ~1 flop a byte.  fwd.cu gives each
// warp 32 query rows, so at Sq = 4 28 rows idle, and only BH items walk
// every key: 12 warps on 132 SMs at BH 12.
//
// Design: one block is (b, h, split s), 4 warps, each warp one tile of KT
// keys (short.cuh), so BH x ceil(Sk / SPLIT) blocks (1664 at BH 208, Sk
// 1024; 384 at BH 12, Sk 4096), several resident an SM and each tile's
// copy in flight while other blocks compute.  A warp copies its K and V
// tile and (warp 0) the block's Sq query rows with 16-byte cp.async;
// lanes own keys and score each against every query row (q read as
// broadcasts), the row maxima meet by shuffles, P goes through shared
// memory, and the lanes then own columns for acc = P V (each P value a
// broadcast, each V value one read for Sq FMAs).  The 4 warps' (m, l,
// acc) merge in warp order into the block's partial, stored to the
// workspace; the last block of (b, h) to arrive (an integer ticket)
// merges the splits' partials in split order (online: a running maximum
// rescales the running sums) and writes o and lse.  Every sum runs in a
// fixed order, so two launches give the same bits.  There is no ring
// inside a warp: a persistent variant with a two-stage ring a warp (as
// fwd.cu) held two blocks an SM and was slower at both set-mixer shapes;
// here five blocks an SM are resident, and their copies overlap one
// another's compute.

#include "short.cuh"

namespace fa {
namespace {

using namespace shortq;

template <typename T, int DM, int SQ>
struct FwdSplit : Cfg<T, DM, SQ> {
  using B = Cfg<T, DM, SQ>;
  // a warp's partial, over its own K and V tile once that is read:
  // m[SQ], l[SQ], acc[SQ][DM]
  static constexpr int PART = SQ * (DM + 2);
  static constexpr int Q_OFF = kWarps * B::WARP_BYTES;
  static constexpr int P_OFF = Q_OFF + SQ * B::PITCH * (int)sizeof(T);
  static constexpr int FLAG_OFF = P_OFF + kWarps * B::KT * SQ * 4;
  static constexpr int SMEM = FLAG_OFF + 16;
  static_assert(PART * 4 <= B::WARP_BYTES, "partial fits the tile");
};

template <typename T, int DM, int SQ>
__global__ void __launch_bounds__(kThreads)
fa_fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, float* __restrict__ part,
                    int* __restrict__ tickets, Lay lq, Lay lk, Lay lv,
                    Lay lout, Prob p, int S) {
  using C = FwdSplit<T, DM, SQ>;
  constexpr int CPK = C::CPK, KT = C::KT, NU = C::NU, DPL = C::DPL;
  constexpr int PITCH = C::PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* Ks = reinterpret_cast<T*>(smem + w * C::WARP_BYTES);
  T* Vs = Ks + C::TILE;
  T* Qs = reinterpret_cast<T*>(smem + C::Q_OFF);
  float* Pw = reinterpret_cast<float*>(smem + C::P_OFF) + w * KT * SQ;
  int* flag = reinterpret_cast<int*>(smem + C::FLAG_OFF);
  const Masks mk = p.mk;
  const int Sq = mk.Sq, Sk = mk.Sk, D = p.D;
  const int bh = blockIdx.x / S, s = blockIdx.x % S;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group();
  const int k0 = s * C::SPLIT + w * KT;
  const int nk = max(0, min(KT, Sk - k0));
  const int kc = nk > 0 ? k0 : 0;

  load_rows<T, DM, PITCH>(Ks, k + lk.at(b, hk, kc), lk.ss, KT, nk, D, p.vec,
                          lane, 32);
  load_rows<T, DM, PITCH>(Vs, v + lv.at(b, hk, kc), lv.ss, KT, nk, D, p.vec,
                          lane, 32);
  if (w == 0)
    load_rows<T, DM, PITCH>(Qs, q + lq.at(b, h, 0), lq.ss, SQ, Sq, D, p.vec,
                            lane, 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // scores of the lane's key (j, columns of chunk c) against every row
  const int j = lane / CPK, c = lane % CPK, kp = k0 + j;
  const bool valid = j < nk;
  float sc[SQ];
#pragma unroll
  for (int r = 0; r < SQ; ++r) sc[r] = 0.f;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int col = 4 * (u * CPK + c);
    float kx[4];
    ld4(Ks + j * PITCH + col, kx);
#pragma unroll
    for (int r = 0; r < SQ; ++r) {
      float qx[4];
      ld4(Qs + r * PITCH + col, qx);
#pragma unroll
      for (int x = 0; x < 4; ++x) sc[r] = fmaf(qx[x], kx[x], sc[r]);
    }
  }
  float m[SQ];
#pragma unroll
  for (int r = 0; r < SQ; ++r) {
    sc[r] = key_sum<CPK>(sc[r]);
    sc[r] = (kp >= mk.lo(r) && kp <= mk.hi(r)) ? sc[r] * p.scale : kMasked;
    // a lane past Sk holds no key: -1e30 is every row's floor, and its p
    // is 0 below
    m[r] = warp_max(valid ? sc[r] : kMasked);
    sc[r] = valid ? expf(sc[r] - m[r]) : 0.f;
  }
  if (c == 0) {
#pragma unroll
    for (int r = 0; r < SQ; r += 4)
      *reinterpret_cast<float4*>(Pw + j * SQ + r) =
          make_float4(sc[r], sc[r + 1], sc[r + 2], sc[r + 3]);
  }
  __syncwarp();

  // acc = P V and l = the sum of P, lanes owning columns lane * DPL ..
  float acc[SQ][DPL], l[SQ];
#pragma unroll
  for (int r = 0; r < SQ; ++r) {
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }
#pragma unroll 8
  for (int jj = 0; jj < KT; ++jj) {
    float pj[SQ], vx[DPL];
#pragma unroll
    for (int r = 0; r < SQ; r += 4) {
      const float4 t = *reinterpret_cast<const float4*>(Pw + jj * SQ + r);
      pj[r] = t.x; pj[r + 1] = t.y; pj[r + 2] = t.z; pj[r + 3] = t.w;
    }
    ld_n<DPL>(Vs + jj * PITCH + lane * DPL, vx);
#pragma unroll
    for (int r = 0; r < SQ; ++r) {
      l[r] += pj[r];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pj[r], vx[e], acc[r][e]);
    }
  }
  // the warp's partial, over its own tile
  __syncwarp();
  float* mine = reinterpret_cast<float*>(smem + w * C::WARP_BYTES);
  if (lane < SQ) {
    float mv = m[0], lv_ = l[0];
#pragma unroll
    for (int r = 1; r < SQ; ++r)
      if (lane == r) { mv = m[r]; lv_ = l[r]; }
    mine[lane] = mv;
    mine[SQ + lane] = lv_;
  }
#pragma unroll
  for (int r = 0; r < SQ; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      mine[2 * SQ + r * DM + lane * DPL + e] = acc[r][e];
  __syncthreads();

  // the block's partial: the warps merged in warp order
  const long long pstride = (long long)Sq * (D + 2);
  float* pb = part + ((long long)bh * S + s) * pstride;
  for (int e = threadIdx.x; e < Sq * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float mb = kMasked;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      mb = fmaxf(mb, reinterpret_cast<const float*>(
                         smem + ww * C::WARP_BYTES)[r]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float* wp =
          reinterpret_cast<const float*>(smem + ww * C::WARP_BYTES);
      const float wt = expf(wp[r] - mb);
      lb += wp[SQ + r] * wt;
      ab += wp[2 * SQ + r * DM + d] * wt;
    }
    if (d == 0) {
      pb[r] = mb;
      pb[Sq + r] = lb;
    }
    pb[2 * Sq + e] = ab;
  }
  if (!last_block(tickets + bh, S, flag)) return;

  // the last block of (b, h): the splits merged in split order, online
  // (the running maximum rescales the sums), their partials read kBatch
  // splits at a time so the reads are in flight together
  const float* pr = part + (long long)bh * S * pstride;
  for (int e = threadIdx.x; e < Sq * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float mx = kMasked, lt = 0.f, at = 0.f;
    for (int t0 = 0; t0 < S; t0 += kBatch) {
      float mv[kBatch], lv_[kBatch], av[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const float* ps = pr + (long long)min(t0 + i, S - 1) * pstride;
        mv[i] = __ldcg(ps + r);
        lv_[i] = __ldcg(ps + Sq + r);
        av[i] = __ldcg(ps + 2 * Sq + e);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (t0 + i < S) {
          const float mn = fmaxf(mx, mv[i]);
          const float a = expf(mx - mn), wt = expf(mv[i] - mn);
          lt = lt * a + lv_[i] * wt;
          at = at * a + av[i] * wt;
          mx = mn;
        }
      }
    }
    o[lout.at(b, h, r) + d] = from_f<T>(at / fmaxf(lt, 1e-30f));
    if (d == 0) lse[(long long)bh * Sq + r] = mx + logf(lt);
  }
}

template <typename T, int DM, int SQ>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        float* part, int* tickets, const Lay* L, const Prob& p, int S,
        cudaStream_t stream) {
  using C = FwdSplit<T, DM, SQ>;
  static int done[16] = {0};
  if (!allow_smem(fa_fwd_split_kernel<T, DM, SQ>, C::SMEM, done))
    return (int)cudaErrorInvalidConfiguration;
  const long long grid = (long long)p.B * p.Hq * S;
  fa_fwd_split_kernel<T, DM, SQ><<<(unsigned)grid, kThreads, C::SMEM,
                                   stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, part, tickets, L[0],
      L[1], L[2], L[3], p, S);
  return (int)cudaGetLastError();
}

template <typename T, int DM>
int by_sq(const void* q, const void* k, const void* v, void* o, float* lse,
          float* part, int* tickets, const Lay* L, const Prob& p, int S,
          cudaStream_t s) {
  if (p.mk.Sq <= 4)
    return run<T, DM, 4>(q, k, v, o, lse, part, tickets, L, p, S, s);
  return run<T, DM, 8>(q, k, v, o, lse, part, tickets, L, p, S, s);
}

template <typename T>
int by_d(const void* q, const void* k, const void* v, void* o, float* lse,
         float* part, int* tickets, const Lay* L, const Prob& p, int S,
         cudaStream_t s) {
  if (p.D <= 32)
    return by_sq<T, 32>(q, k, v, o, lse, part, tickets, L, p, S, s);
  if (p.D <= 64)
    return by_sq<T, 64>(q, k, v, o, lse, part, tickets, L, p, S, s);
  return by_sq<T, 128>(q, k, v, o, lse, part, tickets, L, p, S, s);
}

}  // namespace
}  // namespace fa

// C entry point for ctypes: as flash_attention_fwd_launch, with the
// split (keys a block: the wrapper's route function's, the one value
// short.cuh's split_for gives at this D; any other is refused), the
// partials' workspace (f32, [B * Hq, ceil(Sk / split), Sq, D + 2]) and
// the tickets (B * Hq ints, 0 before the call and put back to 0 by it).
// Refuses Sq > 8 and D > 128 with cudaErrorInvalidValue.  One launch.
extern "C" int flash_attention_fwd_split_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    float* part, int* tickets, const long long* strides, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, int causal, int window, float scale,
    int dtype, int split, void* stream) {
  using namespace fa;
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (D <= 0 || D > 128 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Sq > shortq::kMaxSq || dtype < 0 || dtype > 1 ||
      split != shortq::split_for(D))
    return (int)cudaErrorInvalidValue;
  const long long S = ((long long)Sk + split - 1) / split;
  if ((long long)B * Hq * S >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Lay L[4];
  for (int i = 0; i < 4; ++i)
    L[i] = Lay{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const void* ptrs[4] = {q, k, v, o};
  const int esize = dtype == 0 ? 4 : 2;
  Prob p{B, Hq, Hkv, D, Masks{Sq, Sk, causal, window}, scale,
         aligned16(ptrs, 4, strides, 12, D, esize)};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? by_d<float>(q, k, v, o, lse, part, tickets, L, p, (int)S, s)
             : by_d<__nv_bfloat16>(q, k, v, o, lse, part, tickets, L, p,
                                   (int)S, s);
}
