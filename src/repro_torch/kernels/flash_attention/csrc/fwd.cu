// Flash attention forward for Hopper (sm_90a): persistent, pipelined,
// vectorised, reading and writing the model layout through strides.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (`flash_attention_bhsd` :67, pallas_call at :81; body `_kernel` :27; its
// oracle is flash_attention/ref.py).  For q [B, Hq, Sq, D] and k, v
// [B, Hkv, Sk, D] in index space (any strides, D contiguous; see
// common.cuh), query head h reading KV head h / group:
//
//   o = softmax(mask((q / sqrt(D)) k^T)) v,   lse = the row log-sum-exp
//
// with f32 accumulation, masked logits set to the FINITE -1e30 (so a row
// that sees no key gets the plain mean of v over exactly Sk keys, as the
// TPU kernel and the oracle do; keys past Sk are left out, not masked),
// and the output divided by max(l, 1e-30).  Masks count both positions
// from 0 (top-left alignment, also when Sq != Sk): causal keeps
// k_pos <= q_pos; a window keeps k_pos > q_pos - window.
//
// Bound: on the transformer path (BH = 2048, S = 32, D = 32, causal) each
// head is a 32x32x32 problem at ~4 flops a byte, far below the card's
// ridge of 20 flops a byte in f32, so the kernel is bound by bytes: q, k,
// v in, o and lse out (33.8 MB, 0.0101 ms at 3.35 TB/s).
//
// Design: one warp owns one work item, (b, h, a tile of MQ query rows),
// and walks the item's key tiles of KT keys; warps are persistent (a grid
// of the blocks that fit on the card) and stride over the items.  Each
// warp has a ring of two stages in shared memory, each with one K and one
// V tile, and two Q tiles (by the parity of the warp's item), all filled
// by 16-byte cp.async copies: the next step's tiles (and on an item's
// first step its Q) are in flight while the warp computes on the current
// one.  A broadcast read of a K or V row
// for every FMA would make shared memory the bound, so both products are
// register-tiled: lane (rg, cg) of RG x CG computes S for query rows
// 4 rg .. 4 rg + 3 by keys cg + CG c, and O for the same rows by the
// 4-column chunks cg + CG e; each value read from shared memory feeds 4
// or more FMAs.  Row maxima and sums meet across the CG lanes of a row
// group by xor shuffles once per tile; P goes through shared memory
// transposed ([key][row]), so a lane reads its 4 rows of one key as one
// vector.  The online softmax rescales once per key tile.  Stores are
// 16-byte vectors where the layout allows.

#include "common.cuh"

namespace fa {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <typename T, int DM>
struct FwdCfg {
  static constexpr int MQ = DM <= 64 ? 32 : 16;   // query rows per item
  static constexpr int KT = DM <= 32 ? 16 : 8;    // keys per staged tile
  static constexpr int RG = MQ / 4;               // row groups of 4 rows
  static constexpr int CG = 32 / RG;              // lanes per row group
  static constexpr int KC = KT / CG;              // keys a lane scores
  static constexpr int EC = DM / 4 / CG;          // 4-column chunks a lane
  static constexpr int PITCH = DM + 16 / (int)sizeof(T);
  static constexpr int QTILE = MQ * PITCH;        // elements
  static constexpr int STAGE = 2 * KT * PITCH;    // K and V tiles
  static constexpr int PT = MQ + 4;               // pitch of P^T
  static constexpr int WARP_SMEM =
      2 * (QTILE + STAGE) * (int)sizeof(T) + KT * PT * 4;
  static constexpr int SMEM = kWarps * WARP_SMEM;
  static_assert(KC >= 1 && EC >= 1, "layout");
};

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, Lay lq, Lay lk, Lay lv, Lay lout,
              Prob p) {
  using C = FwdCfg<T, DM>;
  constexpr int MQ = C::MQ, KT = C::KT, CG = C::CG, KC = C::KC, EC = C::EC;
  constexpr int PITCH = C::PITCH, QTILE = C::QTILE, STAGE = C::STAGE;
  constexpr int PT = C::PT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* mine = smem_raw + (threadIdx.x / 32) * C::WARP_SMEM;
  T* qbuf = reinterpret_cast<T*>(mine);       // [item parity] Q tile
  T* ring = qbuf + 2 * QTILE;                 // [stage] K, V tiles
  float* Pt = reinterpret_cast<float*>(ring + 2 * STAGE);
  const int lane = threadIdx.x % 32, rg = lane / CG, cg = lane % CG;
  const Masks mk = p.mk;
  const int Sq = mk.Sq, Sk = mk.Sk, D = p.D, group = p.group();
  const int n_qt = (Sq + MQ - 1) / MQ;
  const long long n_items = (long long)p.B * p.Hq * n_qt;
  const long long stride = (long long)gridDim.x * kWarps;

  // the keys an item needs: every key when one of its rows sees none
  // (emptiness grows with q, so the last row tells), else the union of
  // the rows' ranges (lo and hi grow with q)
  auto range = [&](long long it, int& kb, int& ke) {
    const int q0 = (int)(it % n_qt) * MQ, ql = min(q0 + MQ, Sq) - 1;
    kb = mk.lo(q0);
    ke = mk.hi(ql) + 1;
    if (mk.lo(ql) > mk.hi(ql)) { kb = 0; ke = Sk; }
  };
  // the loads of step (item it, key tile kt) into ring stage `stage`,
  // and of the item's Q tile into Q buffer `qb` on its first step
  auto issue = [&](long long it, int kt, bool first, int stage, int qb) {
    const int bh = (int)(it / n_qt), q0 = (int)(it % n_qt) * MQ;
    const int b = bh / p.Hq, h = bh % p.Hq, hk = h / group;
    if (first)
      load_rows<T, DM, PITCH>(qbuf + qb * QTILE, q + lq.at(b, h, q0), lq.ss,
                              MQ, min(MQ, Sq - q0), D, p.vec, lane, 32);
    T* dst = ring + stage * STAGE;
    const int nk = min(KT, Sk - kt);
    load_rows<T, DM, PITCH>(dst, k + lk.at(b, hk, kt), lk.ss, KT, nk, D,
                            p.vec, lane, 32);
    load_rows<T, DM, PITCH>(dst + KT * PITCH, v + lv.at(b, hk, kt), lv.ss,
                            KT, nk, D, p.vec, lane, 32);
  };
  // sum or max over the CG lanes of a row group (adjacent lanes)
  auto row_max = [&](float x) {
#pragma unroll
    for (int off = 1; off < CG; off *= 2)
      x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
    return x;
  };
  auto row_sum = [&](float x) {
#pragma unroll
    for (int off = 1; off < CG; off *= 2) x += __shfl_xor_sync(kFull, x, off);
    return x;
  };

  float acc[4][EC][4], m[4], l[4];
  long long it = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  int kb = 0, ke = 0, kt = 0, st = 0, n = 0;
  if (it < n_items) {
    range(it, kb, ke);
    kt = kb;
    issue(it, kt, true, 0, 0);
  }
  cp_async_commit();
  while (it < n_items) {
    // the next step: the next key tile, or the first of the next item
    long long it2 = it;
    int kb2 = kb, ke2 = ke, kt2 = kt + KT;
    if (kt2 >= ke) {
      it2 = it + stride;
      if (it2 < n_items) { range(it2, kb2, ke2); kt2 = kb2; }
    }
    if (it2 < n_items) issue(it2, kt2, it2 != it, st ^ 1, (n + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();

    const T* Qs = qbuf + (n & 1) * QTILE;
    const T* Ks = ring + st * STAGE;
    const T* Vs = Ks + KT * PITCH;
    const int bh = (int)(it / n_qt), q0 = (int)(it % n_qt) * MQ;
    if (kt == kb) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        m[a] = kMasked;
        l[a] = 0.f;
#pragma unroll
        for (int e = 0; e < EC; ++e)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[a][e][x] = 0.f;
      }
    }

    // S for rows 4 rg + a, keys cg + CG c
    float s[4][KC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < KC; ++c) s[a][c] = 0.f;
    const int nd4 = (D + 3) / 4;
#pragma unroll 2
    for (int u = 0; u < nd4; ++u) {
      float kx[KC][4];
#pragma unroll
      for (int c = 0; c < KC; ++c)
        ld4(Ks + (cg + CG * c) * PITCH + 4 * u, kx[c]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float qx[4];
        ld4(Qs + (4 * rg + a) * PITCH + 4 * u, qx);
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[a][c] = fmaf(qx[x], kx[c][x], s[a][c]);
      }
    }
    // masks, the tile's row maxima and the online rescale
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q0 + 4 * rg + a;
      const int lo = mk.lo(qp), hi = mk.hi(qp);
      float mt = kMasked;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int kp = kt + cg + CG * c;
        // keys past Sk are not keys: -inf never wins the max and gives
        // p = 0; keys inside Sk but masked take the finite -1e30
        s[a][c] = kp < Sk ? ((kp >= lo && kp <= hi) ? s[a][c] * p.scale
                                                    : kMasked)
                          : -INFINITY;
        mt = fmaxf(mt, s[a][c]);
      }
      const float m_new = fmaxf(m[a], row_max(mt));
      const float alpha = expf(m[a] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        s[a][c] = expf(s[a][c] - m_new);
        ls += s[a][c];
      }
      l[a] = l[a] * alpha + ls;
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < EC; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[a][e][x] *= alpha;
    }
    // P^T to shared memory, then O += P V
#pragma unroll
    for (int c = 0; c < KC; ++c)
      *reinterpret_cast<float4*>(Pt + (cg + CG * c) * PT + 4 * rg) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float pj[4];
      ld4(Pt + j * PT + 4 * rg, pj);
#pragma unroll
      for (int e = 0; e < EC; ++e) {
        float vx[4];
        ld4(Vs + j * PITCH + 4 * (cg + CG * e), vx);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            acc[a][e][x] = fmaf(pj[a], vx[x], acc[a][e][x]);
      }
    }

    if (kt + KT >= ke) {
      const int b = bh / p.Hq, h = bh % p.Hq;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int qp = q0 + 4 * rg + a;
        const float lt = row_sum(l[a]);
        if (qp < Sq) {
          const float inv = 1.f / fmaxf(lt, 1e-30f);
          T* orow = o + lout.at(b, h, qp);
#pragma unroll
          for (int e = 0; e < EC; ++e) {
            const int d0 = 4 * (cg + CG * e);
            if (d0 < D) {
              float x4[4];
#pragma unroll
              for (int x = 0; x < 4; ++x) x4[x] = acc[a][e][x] * inv;
              st4(orow + d0, x4, d0, D, p.vec);
            }
          }
          if (cg == 0) lse[(long long)bh * Sq + qp] = m[a] + logf(lt);
        }
      }
    }
    __syncwarp();
    n += it2 != it;
    it = it2; kb = kb2; ke = ke2; kt = kt2; st ^= 1;
  }
}

template <typename T, int DM>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        const Lay* L, const Prob& p, cudaStream_t stream) {
  using C = FwdCfg<T, DM>;
  static int cache[16] = {0};
  const int nb = persistent_blocks(fa_fwd_kernel<T, DM>, kThreads, C::SMEM,
                                   cache);
  if (nb <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long items =
      (long long)p.B * p.Hq * ((p.mk.Sq + C::MQ - 1) / C::MQ);
  const long long need = (items + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(need < nb ? need : nb);
  fa_fwd_kernel<T, DM><<<grid, kThreads, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, L[0], L[1], L[2],
      L[3], p);
  return (int)cudaGetLastError();
}

template <typename T>
int by_d(const void* q, const void* k, const void* v, void* o, float* lse,
         const Lay* L, const Prob& p, cudaStream_t s) {
  if (p.D <= 32) return run<T, 32>(q, k, v, o, lse, L, p, s);
  if (p.D <= 64) return run<T, 64>(q, k, v, o, lse, L, p, s);
  if (p.D <= 128) return run<T, 128>(q, k, v, o, lse, L, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fa

// C entry point for ctypes.  strides: (batch, head, position) in elements
// for q, k, v and o, 12 int64 (D is contiguous); dtype 0 = float32, 1 =
// bfloat16; causal 0 or 1; window 0 means none.  Launches on `stream`
// (PyTorch's current stream) on the current device, which the caller
// sets; does not synchronise, allocates nothing (the caller passes o and
// lse [B * Hq, Sq] f32); returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const long long* strides, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    int causal, int window, float scale, int dtype, void* stream) {
  using namespace fa;
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (D <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  Lay L[4];
  for (int i = 0; i < 4; ++i)
    L[i] = Lay{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const void* ptrs[4] = {q, k, v, o};
  const int esize = dtype == 0 ? 4 : 2;
  Prob p{B, Hq, Hkv, D, Masks{Sq, Sk, causal, window}, scale,
         aligned16(ptrs, 4, strides, 12, D, esize)};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? by_d<float>(q, k, v, o, lse, L, p, s)
                    : by_d<__nv_bfloat16>(q, k, v, o, lse, L, p, s);
}
