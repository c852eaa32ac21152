// Flash attention forward for Hopper's tensor cores (sm_90a): bf16,
// causal, TMA loads and wgmma products; the wgmma route.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (`flash_attention_bhsd` :67, pallas_call at :81; body `_kernel` :27) for
// the problems the route takes (wgmma.cuh `takes`: bf16, causal, D a
// multiple of 16 up to 128, Sq >= 64, every row sees a key, TMA's 16-byte
// grid), and computes what fwd.cu computes: for q [B, Hq, Sq, D] and k, v
// [B, Hkv, Sk, D] in index space (D contiguous, free strides), query head
// h reading KV head h / group,
//
//   o = softmax(mask((q / sqrt(D)) k^T)) v,   lse = the row log-sum-exp
//
// written into the same o and lse [B * Hq, Sq] through the same strides.
// Masks count positions from 0: causal keeps k_pos <= q_pos, a window
// keeps k_pos > q_pos - window.  The route's rows all see a key, so the
// -1e30 of a keyless row never arises here; masked scores are -inf inside
// a tile and the running maximum guards its -inf.
//
// Bound: at the LM's prefill (B 4, S 2048, 32 heads, D 96) the two
// products are 4 D flops a kept pair, 0.103 ms at the bf16 dense peak,
// against 6.3 us of bytes: operations bound it, and only wgmma reaches the
// tensor cores' rate.
//
// Design (hopper-kernels guide §1): one block per (b, h, 128 query rows),
// the blocks with the most key tiles first.  Three warpgroups: two
// consumers of 64 query rows each, and a producer whose one thread issues
// TMA (setmaxnreg moves the producer's registers to the consumers).  The
// producer loads the block's Q once, then K and V tiles of 128 keys into a
// ring of two stages (full barriers for K and V apart, so S = Q K^T starts
// before V lands; an empty barrier the consumers release).  A consumer
// computes S = Q K^T with wgmma m64n128k16 (both operands in shared
// memory), the online softmax in float32 registers with the scale and
// log2(e) folded into one FMA, rounds P to bf16 into the A fragments of
// O += P V (m64nDNk16, V MN-major through the transpose bit), and keeps O,
// m and l in float32.  Key tiles outside the causal triangle or the window
// are never loaded; only tiles that cross the diagonal, the window's edge
// or Sk are masked.  Epilogue: o = acc / max(l, 1e-30), lse = m + log(l).
// D is padded to DN (64, 96 or 128): the boxes' columns past D are zeros.

#include "common.cuh"
#include "wgmma.cuh"

namespace fa {
namespace {

using namespace wg;

constexpr int kBM = 128;       // query rows a block (two warpgroups)
constexpr int kKT = 128;       // keys a tile
constexpr int kStages = 2;

template <int DN>
struct FwdLayout {
  static constexpr int DB = (DN + kBox - 1) / kBox;
  static constexpr int Q = kBM * DB * 128;          // [wg][box][64][64]
  static constexpr int KV = kKT * DB * 128;         // one K or V tile
  static constexpr int K0 = Q;                      // K stages
  static constexpr int V0 = K0 + kStages * KV;      // V stages
  static constexpr int BAR = V0 + kStages * KV;     // barriers
  static constexpr int BYTES = BAR + 128 + 1024;    // + alignment slack
};

struct FwdArgs {
  __nv_bfloat16* o;
  float* lse;
  Lay lo;
  int B, Hq, group, Sq, Sk, D, window, n_mblocks;
  float scale_log2;              // 1/sqrt(D) * log2(e)
};

// S = q k^T of one key tile into sc (issued, not waited for)
template <int DN>
__device__ __forceinline__ void issue_scores(float (&sc)[kKT / 2],
                                             uint32_t q_tile,
                                             uint32_t k_tile) {
#pragma unroll
  for (int i = 0; i < kKT / 2; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DN / 16; ++kk)
    wgmma_ss<kKT>(sc, desc_k<64>(q_tile, kk), desc_k<kKT>(k_tile, kk), 1);
  wgmma_commit();
}

// The online softmax of one score tile (keys n0 .., rows r0 and r0 + 8):
// mask where the tile crosses the diagonal, the window's edge or Sk,
// update the running maximum m and sum l, leave p = exp2(s scale log2(e)
// - m) in sc and the rescale of the rows' earlier sums in alpha
__device__ __forceinline__ void softmax_tile(float (&sc)[kKT / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int n0,
                                             int r0, int lane, int wg_first,
                                             int wg_last, const FwdArgs& a) {
  const bool need = n0 + kKT - 1 > min(wg_first, a.Sk - 1) ||
                    n0 + kKT > a.Sk ||
                    (a.window > 0 && n0 < wg_last - a.window + 1);
  if (need) {
#pragma unroll
    for (int i = 0; i < kKT / 2; ++i) {
      const int row = r0 + 8 * ((i / 2) % 2);
      const int col = n0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      const bool vis = col <= row && col < a.Sk &&
                       (a.window <= 0 || col > row - a.window);
      if (!vis) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY}, mu[2];
#pragma unroll
  for (int i = 0; i < kKT / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * a.scale_log2);
    mu[r] = mn == -INFINITY ? 0.f : mn;
    alpha[r] = exp2f(m[r] - mu[r]);
    m[r] = mn;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kKT / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = exp2f(fmaf(sc[i], a.scale_log2, -mu[r]));
    ls[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], ls[r]);
}

template <int DN>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, FwdArgs a) {
  using L = FwdLayout<DN>;
  constexpr int DB = L::DB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // barriers: q full, k full x S, v full x S, empty x S
  const uint32_t bar = base + L::BAR;
  const uint32_t q_full = bar, k_full = bar + 8;
  const uint32_t v_full = bar + 8 * (1 + kStages);
  const uint32_t empty = bar + 8 * (1 + 2 * kStages);

  const int BH = a.B * a.Hq;
  const int mb = a.n_mblocks - 1 - (int)blockIdx.x / BH;  // longest first
  const int bh = (int)blockIdx.x % BH;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.group;
  const int m0 = mb * kBM;
  const int last = min(m0 + kBM, a.Sq) - 1;
  const int k_lo = a.window > 0 ? max(0, m0 - a.window + 1) : 0;
  const int k_hi = min(last, a.Sk - 1);
  const int t_lo = k_lo / kKT, n_tiles = k_hi / kKT - t_lo + 1;

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
    // ---- producer ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::Q);
#pragma unroll
      for (int w = 0; w < 2; ++w)
        tma_tile<DB, 64>(base + w * DB * 64 * 128, &tq, q_full, m0 + 64 * w,
                         h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, par = (t / kStages) & 1;
        mbar_wait(empty + 8 * s, par ^ 1);
        const int row = (t_lo + t) * kKT;
        mbar_expect_tx(k_full + 8 * s, L::KV);
        tma_tile<DB, kKT>(base + L::K0 + s * L::KV, &tk, k_full + 8 * s, row,
                         hk, b);
        mbar_expect_tx(v_full + 8 * s, L::KV);
        tma_tile<DB, kKT>(base + L::V0 + s * L::KV, &tv, v_full + 8 * s, row,
                         hk, b);
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int r0 = m0 + 64 * wgi + 16 * w + lane / 4;   // and r0 + 8
  const int wg_first = m0 + 64 * wgi;
  const int wg_last = min(wg_first + 63, a.Sq - 1);
  const uint32_t q_tile = base + wgi * DB * 64 * 128;
  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, par = (it / kStages) & 1;
    float sc[kKT / 2];
    mbar_wait(k_full + 8 * s, par);
    issue_scores<DN>(sc, q_tile, base + L::K0 + s * L::KV);
    wgmma_wait0();
    fence_regs(sc);
    softmax_tile(sc, m, l, alpha, (t_lo + it) * kKT, r0, lane, wg_first,
                 wg_last, a);
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
    uint32_t pa[kKT / 16][4];
    to_frags<kKT>(sc, pa);

    mbar_wait(v_full + 8 * s, par);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKT / 16; ++j)
      wgmma_rs_tb<DN>(acc, pa[j], desc_mn<kKT>(base + L::V0 + s * L::KV, j),
                      1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }

  // ---- epilogue ----
  const int q4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = a.o + a.lo.at(b, h, row);
#pragma unroll
    for (int c = 0; c < DN / 8; ++c) {
      const int col = 8 * c + 2 * q4;
      if (col < a.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * r] / den,
                                  acc[4 * c + 2 * r + 1] / den);
    }
    if (q4 == 0)
      a.lse[(long long)bh * a.Sq + row] = (m[r] + log2f(l[r])) * kLn2;
  }
}

template <int DN>
int launch(const void* q, const void* k, const void* v,
           const long long* strides, int Hkv, const FwdArgs& a,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, a.D, a.Sq, a.Hq, a.B, strides, 64) ||
      !make_map(&tk, k, a.D, a.Sk, Hkv, a.B, strides + 3, kKT) ||
      !make_map(&tv, v, a.D, a.Sk, Hkv, a.B, strides + 6, kKT))
    return (int)cudaErrorInvalidValue;
  const int bytes = FwdLayout<DN>::BYTES;
  if (!set_smem(fa_fwd_wgmma_kernel<DN>, bytes))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)a.n_mblocks * a.B * a.Hq;
  fa_fwd_wgmma_kernel<DN><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fa

// Same arguments as flash_attention_fwd_launch (fwd.cu); strides are q, k,
// v, o, each (batch, head, position).  Refuses (cudaErrorInvalidValue) a
// problem the route does not take.
extern "C" int flash_attention_fwd_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const long long* strides, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    int causal, int window, float scale, int dtype, void* stream) {
  using namespace fa;
  using namespace fa::wg;
  if (B == 0 || Hq == 0) return 0;
  const void* ptrs[4] = {q, k, v, o};
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      !takes(dtype, causal, D, Sq, Sk, window, ptrs, 4, strides, 12))
    return (int)cudaErrorInvalidValue;
  if (const int rc = bind_context(q)) return rc;
  FwdArgs a{(__nv_bfloat16*)o, lse,
            Lay{strides[9], strides[10], strides[11]}, B, Hq, Hq / Hkv, Sq,
            Sk, D, window, (Sq + kBM - 1) / kBM, scale * kLog2e};
  cudaStream_t s = (cudaStream_t)stream;
  return D <= 64 ? launch<64>(q, k, v, strides, Hkv, a, s)
                 : D <= 96 ? launch<96>(q, k, v, strides, Hkv, a, s)
                           : launch<128>(q, k, v, strides, Hkv, a, s);
}
