// Flash attention backward for Hopper's tensor cores (sm_90a): bf16,
// causal, TMA loads and wgmma products, deterministic (no atomics); the
// wgmma route's backward.
//
// Replaces the backward of the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (`flash_attention_bhsd` :67, pallas_call at :81; the TPU gets its
// gradient from jax.grad of ops.py's custom_vjp) for the problems
// fwd_wgmma.cu takes, and computes what bwd_three_pass.cu computes: dq,
// dk, dv of o = softmax(mask((q / sqrt(D)) k^T)) v from the forward's o
// and lse, through the same (batch, head, position) strides.  Every row
// sees a key on this route (wgmma.cuh `takes`), so the 1/Sk of a keyless
// row never arises.
//
// Bound: at the LM's prefill shape (B 4, S 2048, 32 heads, D 96) the five
// products are 10 D flops a kept pair, 0.26 ms at the bf16 dense peak:
// operations bound it.
//
// Design: two launches, the plan of bwd_three_pass.cu on wgmma and TMA.
// Only the products' operands are bf16 (q, k, v, dO as given; P and dS
// rounded once, dS formed from the rounded P, alike in both launches);
// S, dP, delta and the dq, dk, dv accumulators are float32.
//  1. dq (and delta): one block per (b, h, 128 query rows), two consumer
//     warpgroups of 64 rows and a TMA producer, as the forward.  Each
//     consumer first takes delta = rowsum(dO o) for its rows from global
//     memory (each row's columns chained in order) and writes the row
//     statistics (lse log2(e) and delta, 64 rows a record) for launch 2;
//     then, over the key tiles of 64 that its rows see: S = q k^T and
//     dP = dO v^T (m64n64k16, shared operands), P = exp2(S scale log2(e)
//     - lse log2(e)) rounded to bf16, dS = P (dP - delta) rounded to bf16
//     in registers, dq += dS k (k MN-major); dq = scale dq.
//  2. dk, dv: one block per (b, KV head, 128 keys), two consumer
//     warpgroups of 64 keys; K and V stay in shared memory, and the
//     producer streams the group's query heads' tiles of 64 rows (q, dO
//     and their row statistics, one bulk copy) through a ring of two
//     stages.  A consumer computes S^T = k q^T and P^T (as above, packed
//     to bf16 fragments, S^T then dead), then dv += P^T dO and dP^T = v
//     dO^T together, then dS^T = P^T (dP^T - delta) and dk += dS^T q (dO
//     and q MN-major); dk = scale dk.  At most one 64 x 64 float32 tile
//     is live beside dk and dv, which keeps D 128 within the registers.
//     The sums run over heads and query tiles in one fixed order: two
//     launches give the same bits.

#include "common.cuh"
#include "wgmma.cuh"

namespace fa {
namespace {

using namespace wg;

constexpr int kBM = 128;       // query rows (launch 1) or keys (launch 2)
constexpr int kT = 64;         // keys (launch 1) or query rows (launch 2)
constexpr int kStages = 2;
constexpr int kStat = 2 * 64 * 4;   // one record: lse log2(e), delta

struct BwdArgs {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;
  float* stats;                  // [B * Hq][n_mt][2][64]
  __nv_bfloat16 *dq, *dk, *dv;
  Lay lo, ldo, ldq, ldk, ldv;
  int B, Hq, Hkv, group, Sq, Sk, D, window, n_mt;
  float scale, scale_log2;
};

__device__ __forceinline__ bool visible(int q, int k, const BwdArgs& a) {
  return k <= q && q < a.Sq && k < a.Sk &&
         (a.window <= 0 || k > q - a.window);
}

template <int DN>
struct DqLayout {
  static constexpr int DB = (DN + kBox - 1) / kBox;
  static constexpr int Q = kBM * DB * 128;          // q or dO, two warpgroups
  static constexpr int KV = kT * DB * 128;          // one K or V tile
  static constexpr int DO0 = Q;
  static constexpr int K0 = 2 * Q;
  static constexpr int V0 = K0 + kStages * KV;
  static constexpr int DELTA = V0 + kStages * KV;   // [2][64] floats
  static constexpr int BAR = DELTA + 512;
  static constexpr int BYTES = BAR + 64 + 1024;
};

template <int DN>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, BwdArgs a) {
  using L = DqLayout<DN>;
  constexpr int DB = L::DB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  float* delta_s = reinterpret_cast<float*>(smem_raw + (base + L::DELTA -
                                                        smem_u32(smem_raw)));
  const uint32_t bar = base + L::BAR;
  const uint32_t q_full = bar, k_full = bar + 8;
  const uint32_t v_full = bar + 8 * (1 + kStages);
  const uint32_t empty = bar + 8 * (1 + 2 * kStages);

  const int BH = a.B * a.Hq;
  const int n_mblocks = (a.Sq + kBM - 1) / kBM;
  const int mb = n_mblocks - 1 - (int)blockIdx.x / BH;   // longest first
  const int bh = (int)blockIdx.x % BH;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.group;
  const int m0 = mb * kBM;
  const int last = min(m0 + kBM, a.Sq) - 1;
  const int k_lo = a.window > 0 ? max(0, m0 - a.window + 1) : 0;
  const int k_hi = min(last, a.Sk - 1);
  const int t_lo = k_lo / kT, n_tiles = k_hi / kT - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * L::Q);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        tma_tile<DB, 64>(base + w * DB * 64 * 128, &tq, q_full, m0 + 64 * w,
                         h, b);
        tma_tile<DB, 64>(base + L::DO0 + w * DB * 64 * 128, &tdo, q_full,
                         m0 + 64 * w, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, par = (t / kStages) & 1;
        mbar_wait(empty + 8 * s, par ^ 1);
        const int row = (t_lo + t) * kT;
        mbar_expect_tx(k_full + 8 * s, L::KV);
        tma_tile<DB, kT>(base + L::K0 + s * L::KV, &tk, k_full + 8 * s, row,
                         hk, b);
        mbar_expect_tx(v_full + 8 * s, L::KV);
        tma_tile<DB, kT>(base + L::V0 + s * L::KV, &tv, v_full + 8 * s, row,
                         hk, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, q4 = lane % 4;
  const int wg_first = m0 + 64 * wgi;
  const int wg_last = min(wg_first + 63, a.Sq - 1);
  const int r0 = wg_first + 16 * w + lane / 4;           // and r0 + 8

  // delta = rowsum(dO o): two threads a row, 8-column chunks c, c + 2, ..
  {
    const int row = wg_first + t / 2;
    float sum = 0.f;
    if (row < a.Sq) {
      const __nv_bfloat16* orow = a.o + a.lo.at(b, h, row);
      const __nv_bfloat16* grow = a.dout + a.ldo.at(b, h, row);
      for (int c = t % 2; c < a.D / 8; c += 2) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + 8 * c);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(op[e]);
          const float2 gf = __bfloat1622float2(gp[e]);
          sum = fmaf(of.x, gf.x, sum);
          sum = fmaf(of.y, gf.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (t % 2 == 0) delta_s[64 * wgi + t / 2] = sum;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
  }
  float dl[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    dl[r] = delta_s[row - m0];
    l2[r] = row < a.Sq ? a.lse[(long long)bh * a.Sq + row] * kLog2e : 0.f;
    // the row statistics of launch 2, 64 rows a record
    const int mt = row / 64;
    if (q4 == 0 && mt < a.n_mt) {
      float* rec = a.stats + ((long long)bh * a.n_mt + mt) * 128;
      rec[row % 64] = row < a.Sq ? l2[r] : 0.f;
      rec[64 + row % 64] = row < a.Sq ? dl[r] : 0.f;
    }
  }

  const uint32_t q_tile = base + wgi * DB * 64 * 128;
  const uint32_t do_tile = base + L::DO0 + wgi * DB * 64 * 128;
  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, par = (it / kStages) & 1;
    const int n0 = (t_lo + it) * kT;
    const uint32_t k_tile = base + L::K0 + s * L::KV;
    const uint32_t v_tile = base + L::V0 + s * L::KV;
    float sc[kT / 2], dp[kT / 2];
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    mbar_wait(k_full + 8 * s, par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DN / 16; ++kk)
      wgmma_ss<kT>(sc, desc_k<64>(q_tile, kk), desc_k<kT>(k_tile, kk), 1);
    mbar_wait(v_full + 8 * s, par);
#pragma unroll
    for (int kk = 0; kk < DN / 16; ++kk)
      wgmma_ss<kT>(dp, desc_k<64>(do_tile, kk), desc_k<kT>(v_tile, kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);

    const bool need = n0 + kT - 1 > min(wg_first, a.Sk - 1) ||
                      n0 + kT > a.Sk || wg_first + 63 >= a.Sq ||
                      (a.window > 0 && n0 < wg_last - a.window + 1);
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) {
      const int r = (i / 2) % 2;
      const int col = n0 + 8 * (i / 4) + 2 * q4 + i % 2;
      float p = exp2f(fmaf(sc[i], a.scale_log2, -l2[r]));
      if (need && !visible(r0 + 8 * r, col, a)) p = 0.f;
      sc[i] = round_bf16(p) * (dp[i] - dl[r]);
    }
    uint32_t da[kT / 16][4];
    to_frags<kT>(sc, da);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kT / 16; ++j)
      wgmma_rs_tb<DN>(acc, da[j], desc_mn<kT>(k_tile, j), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.Sq) continue;
    __nv_bfloat16* out = a.dq + a.ldq.at(b, h, row);
#pragma unroll
    for (int c = 0; c < DN / 8; ++c) {
      const int col = 8 * c + 2 * q4;
      if (col < a.D)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * r] * a.scale,
                                  acc[4 * c + 2 * r + 1] * a.scale);
    }
  }
}

template <int DN>
struct DkvLayout {
  // query rows a tile: 64, or 32 at DN 128, where dk, dv and one 64 x 64
  // float32 tile would not fit the registers beside each other
  static constexpr int QT = DN <= 96 ? 64 : 32;
  static constexpr int DB = (DN + kBox - 1) / kBox;
  static constexpr int KV = kBM * DB * 128;         // K or V, two warpgroups
  static constexpr int QS = QT * DB * 128;          // one q or dO tile
  static constexpr int V0 = KV;
  static constexpr int Q0 = 2 * KV;
  static constexpr int DO0 = Q0 + kStages * QS;
  static constexpr int ST0 = DO0 + kStages * QS;    // row statistics
  static constexpr int BAR = ST0 + kStages * kStat;
  static constexpr int BYTES = BAR + 64 + 1024;
};

template <int DN>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, BwdArgs a) {
  using L = DkvLayout<DN>;
  constexpr int DB = L::DB, QT = L::QT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const float* stat_s = reinterpret_cast<const float*>(
      smem_raw + (base + L::ST0 - smem_u32(smem_raw)));
  const uint32_t bar = base + L::BAR;
  const uint32_t kv_full = bar, q_full = bar + 8;
  const uint32_t do_full = bar + 8 * (1 + kStages);
  const uint32_t empty = bar + 8 * (1 + 2 * kStages);

  const int BHk = a.B * a.Hkv;
  const int nb = (int)blockIdx.x / BHk;      // the first keys see the most
  const int bhk = (int)blockIdx.x % BHk;
  const int b = bhk / a.Hkv, hk = bhk % a.Hkv;
  const int n0 = nb * kBM;
  const int n_last = min(n0 + kBM, a.Sk) - 1;
  const int q_lo = n0;
  const int q_hi = a.window > 0 ? min(a.Sq - 1, n_last + a.window - 1)
                                : a.Sq - 1;
  const int mt_lo = q_lo / QT;
  const int n_mt = q_lo <= q_hi ? q_hi / QT - mt_lo + 1 : 0;
  const int n_tiles = a.group * n_mt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(do_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * L::KV);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        tma_tile<DB, 64>(base + w * DB * 64 * 128, &tk, kv_full, n0 + 64 * w,
                         hk, b);
        tma_tile<DB, 64>(base + L::V0 + w * DB * 64 * 128, &tv, kv_full,
                         n0 + 64 * w, hk, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, par = (t / kStages) & 1;
        const int h = hk * a.group + t / n_mt, mt = mt_lo + t % n_mt;
        mbar_wait(empty + 8 * s, par ^ 1);
        mbar_expect_tx(q_full + 8 * s, L::QS + kStat);
        tma_tile<DB, QT>(base + L::Q0 + s * L::QS, &tq, q_full + 8 * s,
                         mt * QT, h, b);
        const float* rec = a.stats + ((long long)(b * a.Hq + h) * a.n_mt +
                                      mt * QT / 64) * 128;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n" ::"r"(base + L::ST0 + s * kStat),
            "l"(rec), "r"(kStat), "r"(q_full + 8 * s)
            : "memory");
        mbar_expect_tx(do_full + 8 * s, L::QS);
        tma_tile<DB, QT>(base + L::DO0 + s * L::QS, &tdo, do_full + 8 * s,
                         mt * QT, h, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, q4 = lane % 4;
  const int kw0 = n0 + 64 * wgi;
  const int kr0 = kw0 + 16 * w + lane / 4;               // and kr0 + 8
  const uint32_t k_tile = base + wgi * DB * 64 * 128;
  const uint32_t v_tile = base + L::V0 + wgi * DB * 64 * 128;
  float dk[DN / 2], dv[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, par = (it / kStages) & 1;
    const int q0 = (mt_lo + it % n_mt) * QT;
    const uint32_t q_tile = base + L::Q0 + s * L::QS;
    const uint32_t do_tile = base + L::DO0 + s * L::QS;
    const float* st = stat_s + s * 128 + q0 % 64;   // this tile's rows
    // S^T = k q^T, then P^T; S^T is dead before dP^T is live
    float sc[QT / 2];
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    mbar_wait(q_full + 8 * s, par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DN / 16; ++kk)
      wgmma_ss<QT>(sc, desc_k<64>(k_tile, kk), desc_k<QT>(q_tile, kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    const bool need = q0 < kw0 + 63 || q0 + QT > a.Sq || kw0 + 63 >= a.Sk ||
                      (a.window > 0 && q0 + QT - 1 > kw0 + a.window - 1);
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) {
      const int c = 8 * (i / 4) + 2 * q4 + i % 2;       // query in the tile
      sc[i] = exp2f(fmaf(sc[i], a.scale_log2, -st[c]));
      if (need && !visible(q0 + c, kr0 + 8 * ((i / 2) % 2), a)) sc[i] = 0.f;
    }
    uint32_t pa[QT / 16][4];
    to_frags<QT>(sc, pa);

    // dv += P^T dO and dP^T = v dO^T, issued together
    float dp[QT / 2];
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) dp[i] = 0.f;
    fence_regs(dp);
    fence_regs(dv);
    mbar_wait(do_full + 8 * s, par);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < QT / 16; ++j)
      wgmma_rs_tb<DN>(dv, pa[j], desc_mn<QT>(do_tile, j), 1);
#pragma unroll
    for (int kk = 0; kk < DN / 16; ++kk)
      wgmma_ss<QT>(dp, desc_k<64>(v_tile, kk), desc_k<QT>(do_tile, kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dp);
    fence_regs(dv);

    // dS^T = P^T (dP^T - delta), then dk += dS^T q
    uint32_t da[QT / 16][4];
#pragma unroll
    for (int j = 0; j < QT / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * j + 2 * r;
        const int c = 8 * (i / 4) + 2 * q4;            // query in the tile
        const float2 pf = unpack_bf16(pa[j][r]);
        da[j][r] = pack_bf16(pf.x * (dp[i] - st[64 + c]),
                             pf.y * (dp[i + 1] - st[64 + c + 1]));
      }
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < QT / 16; ++j)
      wgmma_rs_tb<DN>(dk, da[j], desc_mn<QT>(q_tile, j), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dk);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kr0 + 8 * r;
    if (key >= a.Sk) continue;
    __nv_bfloat16* ko = a.dk + a.ldk.at(b, hk, key);
    __nv_bfloat16* vo = a.dv + a.ldv.at(b, hk, key);
#pragma unroll
    for (int c = 0; c < DN / 8; ++c) {
      const int col = 8 * c + 2 * q4;
      if (col < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(ko + col) =
            __floats2bfloat162_rn(dk[4 * c + 2 * r] * a.scale,
                                  dk[4 * c + 2 * r + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(vo + col) =
            __floats2bfloat162_rn(dv[4 * c + 2 * r], dv[4 * c + 2 * r + 1]);
      }
    }
  }
}

template <int DN>
int launch(const void* const* ptrs, const long long* strides,
           const BwdArgs& a, cudaStream_t stream) {
  constexpr int QT = DkvLayout<DN>::QT;
  // maps: q, k, v, dO with boxes of 64 rows (launch 1), q and dO with
  // boxes of QT rows (launch 2)
  CUtensorMap m[6];
  if (!make_map(&m[0], ptrs[0], a.D, a.Sq, a.Hq, a.B, strides, 64) ||
      !make_map(&m[1], ptrs[1], a.D, a.Sk, a.Hkv, a.B, strides + 3, 64) ||
      !make_map(&m[2], ptrs[2], a.D, a.Sk, a.Hkv, a.B, strides + 6, 64) ||
      !make_map(&m[3], ptrs[4], a.D, a.Sq, a.Hq, a.B, strides + 12, 64) ||
      !make_map(&m[4], ptrs[0], a.D, a.Sq, a.Hq, a.B, strides, QT) ||
      !make_map(&m[5], ptrs[4], a.D, a.Sq, a.Hq, a.B, strides + 12, QT))
    return (int)cudaErrorInvalidValue;
  const int dq_bytes = DqLayout<DN>::BYTES, kv_bytes = DkvLayout<DN>::BYTES;
  if (!set_smem(fa_bwd_dq_wgmma_kernel<DN>, dq_bytes) ||
      !set_smem(fa_bwd_dkdv_wgmma_kernel<DN>, kv_bytes))
    return (int)cudaErrorInvalidValue;
  const long long dq_blocks = (long long)((a.Sq + kBM - 1) / kBM) * a.B * a.Hq;
  const long long kv_blocks = (long long)((a.Sk + kBM - 1) / kBM) * a.B * a.Hkv;
  fa_bwd_dq_wgmma_kernel<DN><<<(unsigned)dq_blocks, kThreads, dq_bytes,
                               stream>>>(m[0], m[1], m[2], m[3], a);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  fa_bwd_dkdv_wgmma_kernel<DN><<<(unsigned)kv_blocks, kThreads, kv_bytes,
                                 stream>>>(m[4], m[1], m[2], m[5], a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fa

// Same arguments as flash_attention_bwd_launch (bwd_three_pass.cu) but for
// `stats`, a float32 workspace of B * Hq * ceil(Sq / 64) * 128 elements
// in place of delta; strides are q, k, v, o, dO, dq, dk, dv, each (batch,
// head, position).  Refuses (cudaErrorInvalidValue) a problem the route
// does not take.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* stats, void* dq, void* dk,
    void* dv, const long long* strides, int B, int Hq, int Hkv, int Sq,
    int Sk, int D, int causal, int window, float scale, int dtype,
    void* stream) {
  using namespace fa;
  using namespace fa::wg;
  if (B == 0 || Hq == 0) return 0;
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      !takes(dtype, causal, D, Sq, Sk, window, ptrs, 8, strides, 24))
    return (int)cudaErrorInvalidValue;
  if (const int rc = bind_context(q)) return rc;
  auto lay = [&](int i) {
    return Lay{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  };
  BwdArgs a{(const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, stats,
            (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
            lay(3), lay(4), lay(5), lay(6), lay(7), B, Hq, Hkv, Hq / Hkv, Sq,
            Sk, D, window, (Sq + kT - 1) / kT, scale, scale * kLog2e};
  cudaStream_t s = (cudaStream_t)stream;
  return D <= 64 ? launch<64>(ptrs, strides, a, s)
                 : D <= 96 ? launch<96>(ptrs, strides, a, s)
                           : launch<128>(ptrs, strides, a, s);
}
