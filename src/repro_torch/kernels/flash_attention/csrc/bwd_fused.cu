// Flash attention backward for short sequences, one launch, for Hopper
// (sm_90a): every head's whole problem in shared memory.
//
// The TPU kernel (src/repro/kernels/flash_attention/flash_attention.py,
// `flash_attention_bhsd` :67) had no backward; this is the gradient of
// fwd.cu's function, for Sq, Sk <= 64 at D <= 64 and <= 32 at D <= 128
// (the wrapper's `fused_backward` picks it by shape; longer sequences go
// to bwd_three_pass.cu).  With p = exp(s - L) from the forward's row
// log-sum-exp L:
//
//   delta = rowsum(dO * O),  dS = P * (dO V^T - delta),
//   dV = sum over the group's heads of P^T dO,
//   dK = sum over the group's heads of dS^T Q / sqrt(D),
//   dQ = dS K / sqrt(D),
//
// with the forward's semantics: a row that sees no key has p = 1/Sk on
// every key (its dV share) and dS = 0; keys past Sk are not keys.
//
// Bound: q, k, v, o, dO and lse in, dq, dk and dv out (67.4 MB at the
// transformer path's BH = 2048, S = 32, D = 32: 0.0201 ms at 3.35 TB/s);
// five products of ~S^2 D flops a head, ~5 flops a byte, below the f32
// ridge, so bytes bound it.  The three-pass backward moves ~110 MB
// (delta, then dK/dV and dQ each re-reading q, k, v, dO, lse and delta)
// and computes s and p twice.
//
// Design: a work item is one KV head with its GQA group of query heads;
// the grid is persistent (the blocks that fit on the card), each block
// striding over the items.  A task is (item, query head).  Shared memory
// holds K and V of two items (double-buffered by the item's parity) and
// Q, O, dO and lse of two tasks (a ring of two stages), all filled by
// 16-byte cp.async copies: the next task's tiles are in flight while the
// block computes the current one.  Warp w owns the rows w RW .. w RW +
// RW - 1, as query rows and as key rows.  Per task:
//   1. delta of the warp's query rows (shuffles within the warp);
//   2. S = Q K^T and dP = dO V^T of the warp's query rows, register-
//      tiled (lane: RA rows by the keys lane % 8 + 8 c), skipping the key
//      blocks of 8 that a causal mask hides from all of the warp's rows;
//      then P and dS once per pair, into shared memory (one barrier);
//   3. for the warp's key rows, dV += P^T dO and dK += dS^T Q over the
//      query rows that can see them (from the warp's first row on, when
//      causal), held in registers over the group's heads and written
//      once per item; for its query rows, dQ = dS K over the keys they
//      can see, written per task.  A lane owns RR rows by 4-column
//      chunks, so each value read from shared memory feeds 4 or more
//      FMAs.
// Causal masks make the warps' loads in steps 2 and 3 complementary:
// early rows see few keys but are seen by many queries.  No atomics:
// every output has one owner thread, which sums in a fixed order, so the
// result is deterministic.

#include "common.cuh"

namespace fa {
namespace {

template <typename T, int MS, int DM, int NT>
struct BwdCfg {
  static constexpr int PITCH = DM + 16 / (int)sizeof(T);
  static constexpr int TILE = MS * PITCH;            // elements
  static constexpr int PP = MS + 4;                  // pitch of P and dS
  static constexpr int W = NT / 32;                  // warps
  static constexpr int RW = MS / W;                  // rows a warp owns
  // phase 2: lane (lane / 8, lane % 8) scores RA query rows by the keys
  // lane % 8 + 8 c, c < KC
  static constexpr int RA = RW / 4, KC = MS / 8;
  // phase 3: lane (lane / CCL, lane % CCL) owns RR rows by EC chunks of
  // 4 columns (lane % CCL + CCL e)
  static constexpr int NCH = DM / 4;
  static constexpr int CCL = NCH < 32 ? NCH : 32;
  static constexpr int RR = RW / (32 / CCL), EC = NCH / CCL;
  static constexpr int SMEM = (4 + 6) * TILE * (int)sizeof(T) +
                              (2 * MS * PP + 3 * MS) * 4;
  // blocks an SM can hold by shared memory, at most as many as leave
  // each thread 128 registers: the launch bounds ask for that many
  static constexpr int BY_SMEM = (227 * 1024) / SMEM;
  static constexpr int MINB = BY_SMEM < 512 / NT ? BY_SMEM : 512 / NT;
  static_assert(RA >= 1 && RR >= 1 && RR <= 4 && MS % 16 == 0 &&
                    RW % 4 == 0 && 32 % RW == 0,
                "layout");
};

struct Lays { Lay q, k, v, o, g, dq, dk, dv; };

// n consecutive floats (n = 1, 2 or 4) from shared memory, as one vector
template <int N>
__device__ __forceinline__ void ldn(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    ld4(p, x);
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

template <typename T, int MS, int DM, int NT>
__global__ void __launch_bounds__(NT, (BwdCfg<T, MS, DM, NT>::MINB))
fa_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    T* __restrict__ dk, T* __restrict__ dv, Lays L, Prob p) {
  using C = BwdCfg<T, MS, DM, NT>;
  constexpr int PITCH = C::PITCH, TILE = C::TILE, PP = C::PP, RW = C::RW;
  constexpr int RA = C::RA, KC = C::KC, CCL = C::CCL, RR = C::RR;
  constexpr int EC = C::EC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kvb = reinterpret_cast<T*>(smem_raw);    // [item parity][K, V]
  T* qb = kvb + 4 * TILE;                     // [stage][Q, O, dO]
  float* Ps = reinterpret_cast<float*>(qb + 6 * TILE);
  float* Ss = Ps + MS * PP;                   // dS
  float* Ls = Ss + MS * PP;                   // [stage][MS] lse
  float* Ds = Ls + 2 * MS;                    // [MS] delta

  const int t = threadIdx.x, lane = t % 32, w0 = (t / 32) * RW;
  const Masks mk = p.mk;
  const int Sq = mk.Sq, Sk = mk.Sk, D = p.D, Hq = p.Hq, Hkv = p.Hkv;
  const int group = p.group();
  const long long n_items = (long long)p.B * Hkv;
  const float inv_sk = 1.f / (float)Sk;
  const int nd4 = (D + 3) / 4;
  // causal: the warp's query rows see no key past its last row, and its
  // key rows are seen by no query row before its first
  const int key_end = mk.causal ? min(Sk, w0 + RW) : Sk;
  const int row_begin = mk.causal ? w0 : 0;

  auto issue = [&](long long item, int hh, int n, int stage) {
    const int b = (int)(item / Hkv), hk = (int)(item % Hkv);
    const int h = hk * group + hh;
    if (hh == 0) {
      T* kv = kvb + (n & 1) * 2 * TILE;
      load_rows<T, DM, PITCH>(kv, k + L.k.at(b, hk, 0), L.k.ss, MS, Sk, D,
                              p.vec, t, NT);
      load_rows<T, DM, PITCH>(kv + TILE, v + L.v.at(b, hk, 0), L.v.ss, MS,
                              Sk, D, p.vec, t, NT);
    }
    T* qs = qb + stage * 3 * TILE;
    load_rows<T, DM, PITCH>(qs, q + L.q.at(b, h, 0), L.q.ss, MS, Sq, D,
                            p.vec, t, NT);
    load_rows<T, DM, PITCH>(qs + TILE, o + L.o.at(b, h, 0), L.o.ss, MS, Sq,
                            D, p.vec, t, NT);
    load_rows<T, DM, PITCH>(qs + 2 * TILE, dout + L.g.at(b, h, 0), L.g.ss,
                            MS, Sq, D, p.vec, t, NT);
    for (int r = t; r < MS; r += NT) {
      float* dst = Ls + stage * MS + r;
      const float* src = lse + ((long long)b * Hq + h) * Sq + r;
      if (r < Sq) cp_async4(dst, src);
      else *dst = 0.f;
    }
  };

  // dV and dK of the lane's RR key rows, summed over the group's heads
  float dva[RR][EC][4], dka[RR][EC][4];
  long long item = blockIdx.x;
  int n = 0, hh = 0, st = 0;
  if (item < n_items) issue(item, 0, 0, 0);
  cp_async_commit();
  while (item < n_items) {
    long long item2 = item;
    int n2 = n, hh2 = hh + 1;
    if (hh2 == group) { hh2 = 0; n2 = n + 1; item2 = item + gridDim.x; }
    cp_async_wait<0>();
    __syncthreads();   // this task's tiles have landed; the other stage
                       // and the other K/V buffer are free
    if (item2 < n_items) issue(item2, hh2, n2, st ^ 1);
    cp_async_commit();

    const T* Ks = kvb + (n & 1) * 2 * TILE;
    const T* Vs = Ks + TILE;
    const T* Qs = qb + st * 3 * TILE;
    const T* Os = Qs + TILE;
    const T* Gs = Os + TILE;
    const float* Lr = Ls + st * MS;
    const int b = (int)(item / Hkv), hk = (int)(item % Hkv);
    const int h = hk * group + hh;

    // 1. delta = rowsum(dO * O) of the warp's RW query rows
    {
      constexpr int LPR = 32 / RW;            // lanes a row
      const int r = w0 + lane / LPR, c0 = lane % LPR;
      float a = 0.f;
      for (int u = c0; u < nd4; u += LPR) {
        float x[4], y[4];
        ld4(Os + r * PITCH + 4 * u, x);
        ld4(Gs + r * PITCH + 4 * u, y);
#pragma unroll
        for (int e = 0; e < 4; ++e) a = fmaf(x[e], y[e], a);
      }
#pragma unroll
      for (int off = 1; off < LPR; off *= 2)
        a += __shfl_xor_sync(kFull, a, off);
      if (c0 == 0) Ds[r] = a;
      __syncwarp();
    }

    // 2. S = Q K^T and dP = dO V^T for the warp's query rows, key blocks
    //    of 8 that some row of the warp sees; then P and dS once per pair
    {
      const int kx = lane % 8, i0 = w0 + (lane / 8) * RA;
      const int cmax = (key_end + 7) / 8;     // key blocks computed
      float sa[RA][KC], da[RA][KC];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < KC; ++c) sa[a][c] = da[a][c] = 0.f;
#pragma unroll 2
      for (int u = 0; u < nd4; ++u) {
        float qx[RA][4], gx[RA][4];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          ld4(Qs + (i0 + a) * PITCH + 4 * u, qx[a]);
          ld4(Gs + (i0 + a) * PITCH + 4 * u, gx[a]);
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (c >= cmax) break;
          float kk[4], vv[4];
          ld4(Ks + (kx + 8 * c) * PITCH + 4 * u, kk);
          ld4(Vs + (kx + 8 * c) * PITCH + 4 * u, vv);
#pragma unroll
          for (int a = 0; a < RA; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sa[a][c] = fmaf(qx[a][e], kk[e], sa[a][c]);
              da[a][c] = fmaf(gx[a][e], vv[e], da[a][c]);
            }
        }
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int i = i0 + a;
        const int lo = mk.lo(i), hi = mk.hi(i);
        const float Li = Lr[i], Di = Ds[i];
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = kx + 8 * c;
          float pp = 0.f, ds = 0.f;
          if (i < Sq && j < Sk) {
            if (lo > hi) {
              pp = inv_sk;
            } else if (j >= lo && j <= hi) {
              pp = expf(sa[a][c] * p.scale - Li);
              ds = pp * (da[a][c] - Di);
            }
          }
          Ps[i * PP + j] = pp;
          Ss[i * PP + j] = ds;
        }
      }
    }
    __syncthreads();

    // 3. lane (lane / CCL, lane % CCL): RR rows j0.. by EC chunks.  The
    //    warp's key rows: dV += P^T dO and dK += dS^T Q over the query
    //    rows that see them; its query rows: dQ = dS K over their keys
    {
      const int cc = lane % CCL, j0 = w0 + (lane / CCL) * RR;
      if (hh == 0) {
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
          for (int e = 0; e < EC; ++e)
#pragma unroll
            for (int x = 0; x < 4; ++x) dva[r][e][x] = dka[r][e][x] = 0.f;
      }
#pragma unroll 2
      for (int i = row_begin; i < Sq; ++i) {
        float pr[RR], sr[RR];
        ldn<RR>(Ps + i * PP + j0, pr);
        ldn<RR>(Ss + i * PP + j0, sr);
#pragma unroll
        for (int e = 0; e < EC; ++e) {
          float g4[4], q4[4];
          ld4(Gs + i * PITCH + 4 * (cc + CCL * e), g4);
          ld4(Qs + i * PITCH + 4 * (cc + CCL * e), q4);
#pragma unroll
          for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              dva[r][e][x] = fmaf(pr[r], g4[x], dva[r][e][x]);
              dka[r][e][x] = fmaf(sr[r], q4[x], dka[r][e][x]);
            }
        }
      }
      float dqa[RR][EC][4];
#pragma unroll
      for (int r = 0; r < RR; ++r)
#pragma unroll
        for (int e = 0; e < EC; ++e)
#pragma unroll
          for (int x = 0; x < 4; ++x) dqa[r][e][x] = 0.f;
      // keys past Sk (and past key_end) hold dS = 0 and K = 0 up to MS
      for (int j = 0; j < key_end; j += 4) {
        float s4[RR][4];
#pragma unroll
        for (int r = 0; r < RR; ++r) ld4(Ss + (j0 + r) * PP + j, s4[r]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < EC; ++e) {
            float k4[4];
            ld4(Ks + (j + jj) * PITCH + 4 * (cc + CCL * e), k4);
#pragma unroll
            for (int r = 0; r < RR; ++r)
#pragma unroll
              for (int x = 0; x < 4; ++x)
                dqa[r][e][x] = fmaf(s4[r][jj], k4[x], dqa[r][e][x]);
          }
      }
#pragma unroll
      for (int e = 0; e < EC; ++e) {
        const int d0 = 4 * (cc + CCL * e);
        if (d0 >= D) continue;
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const int i = j0 + r;
          float x4[4];
          if (i < Sq) {
#pragma unroll
            for (int x = 0; x < 4; ++x) x4[x] = dqa[r][e][x] * p.scale;
            st4(dq + L.dq.at(b, h, i) + d0, x4, d0, D, p.vec);
          }
          if (hh == group - 1 && i < Sk) {
#pragma unroll
            for (int x = 0; x < 4; ++x) x4[x] = dka[r][e][x] * p.scale;
            st4(dk + L.dk.at(b, hk, i) + d0, x4, d0, D, p.vec);
            st4(dv + L.dv.at(b, hk, i) + d0, dva[r][e], d0, D, p.vec);
          }
        }
      }
    }
    item = item2; n = n2; hh = hh2; st ^= 1;
  }
}

template <typename T, int MS, int DM, int NT>
int run(const void* const* ptr, const Lays& L, const Prob& p,
        cudaStream_t stream) {
  using C = BwdCfg<T, MS, DM, NT>;
  static int cache[16] = {0};
  const int nb = persistent_blocks(fa_bwd_fused_kernel<T, MS, DM, NT>, NT,
                                   C::SMEM, cache);
  if (nb <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)p.B * p.Hkv;
  const unsigned grid = (unsigned)(items < nb ? items : nb);
  fa_bwd_fused_kernel<T, MS, DM, NT><<<grid, NT, C::SMEM, stream>>>(
      (const T*)ptr[0], (const T*)ptr[1], (const T*)ptr[2],
      (const T*)ptr[3], (const T*)ptr[4], (const float*)ptr[5], (T*)ptr[6],
      (T*)ptr[7], (T*)ptr[8], L, p);
  return (int)cudaGetLastError();
}

// The shared-memory layouts compiled, smallest first, as X(longest Sq and
// Sk, largest D, threads): Sq, Sk <= 32 at D <= 128, or <= 64 at D <= 64.
// 128 threads where several blocks fit on an SM, 256 where one does.  A
// problem runs the first layout that holds it; the wrapper asks
// flash_attention_bwd_fused_fits, so this is the one place the fused
// route's limits are written.
#define FA_FUSED_LAYOUTS                                        \
  X(32, 32, 128) X(32, 64, 128) X(32, 128, 256) X(64, 32, 256) \
  X(64, 64, 256)

template <typename T>
int by_shape(const void* const* ptr, const Lays& L, const Prob& p,
             cudaStream_t s) {
  const int S = max(p.mk.Sq, p.mk.Sk);
#define X(MS, DM, NT) \
  if (S <= MS && p.D <= DM) return run<T, MS, DM, NT>(ptr, L, p, s);
  FA_FUSED_LAYOUTS
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fa

extern "C" int flash_attention_bwd_fused_fits(int Sq, int Sk, int D) {
  const int S = Sq > Sk ? Sq : Sk;
#define X(MS, DM, NT) \
  if (S <= MS && D <= DM) return 1;
  FA_FUSED_LAYOUTS
#undef X
  return 0;
}

extern "C" int flash_attention_bwd_fused_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    const long long* strides, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    int causal, int window, float scale, int dtype, void* stream) {
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
  const void* data[8] = {q, k, v, o, dout, dq, dk, dv};
  const int esize = dtype == 0 ? 4 : 2;
  Prob p{B, Hq, Hkv, D, Masks{Sq, Sk, causal, window}, scale,
         aligned16(data, 8, strides, 24, D, esize)};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? by_shape<float>(ptr, L, p, s)
                    : by_shape<__nv_bfloat16>(ptr, L, p, s);
}
