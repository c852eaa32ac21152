// Shared pieces of the short-query route (fwd_split.cu, bwd_short.cu):
// attention of Sq <= 8 query rows over a long key set, split over blocks
// by key chunks (flash-decoding).
//
// A block is 4 warps; warp w of the block for split s owns one tile of
// KT keys, keys s * SPLIT + w * KT .. + KT - 1, in shared memory (K and V,
// 16-byte cp.async copies).  Lanes own keys, not rows: CPK adjacent lanes
// share a key and split its D columns (4-column chunks u * CPK + c), so a
// tile of KT = 32 / CPK keys is always 1024 elements and no lane idles on
// a padded query row.  The split (SPLIT keys a block) is fixed by D; the
// wrapper's route function computes the same number and passes it, and
// the entry points refuse any other.
#pragma once

#include "common.cuh"

namespace fa {
namespace shortq {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSq = 8;       // query rows a head, at most
constexpr int kMaxRows = 32;    // GQA group x padded rows, at most
constexpr int kBatch = 8;       // splits a combine reads at once

template <typename T, int DM, int SQ>
struct Cfg {
  static constexpr int CPK = DM / 32;           // lanes a key: 1, 2, 4
  static constexpr int KT = 32 / CPK;           // keys a warp: 32, 16, 8
  static constexpr int SPLIT = kWarps * KT;     // keys a block
  static constexpr int NU = DM / 4 / CPK;       // 4-column chunks a lane dots
  static constexpr int DPL = DM / 32;           // columns a lane owns after
  // a pitch of DM + DM / 8 f32 elements puts the 8 lanes of a
  // quarter-warp's 16-byte reads (2 to 8 keys by 4 to 1 column chunks) on
  // distinct banks; bf16 keeps 16-byte rows
  static constexpr int PITCH = DM + (16 / (int)sizeof(T)) * CPK;
  static constexpr int TILE = KT * PITCH;        // elements
  static constexpr int WARP_BYTES = 2 * TILE * (int)sizeof(T);  // K and V
  static_assert(SQ % 4 == 0 && SQ <= kMaxSq && KT * CPK == 32, "layout");
};

// the padded query rows a kernel instance holds for Sq rows
__host__ __device__ inline int padded_sq(int Sq) { return Sq <= 4 ? 4 : 8; }

// the keys a block takes at head dimension D (the wrapper's split)
inline int split_for(int D) {
  const int dm = D <= 32 ? 32 : (D <= 64 ? 64 : 128);
  return kWarps * 32 / (dm / 32);
}

// N consecutive elements as floats (N = 4: one 16- or 8-byte read)
template <int N, typename T>
__device__ __forceinline__ void ld_n(const T* p, float (&x)[N]) {
  if constexpr (N == 4) {
    ld4(p, x);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = to_f(p[e]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(kFull, x, off);
  return x;
}
// sum over the CPK adjacent lanes that share a key
template <int CPK>
__device__ __forceinline__ float key_sum(float x) {
#pragma unroll
  for (int off = 1; off < CPK; off *= 2) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The ticket of a block's row set: every block of the set calls this
// after its partial is stored; it returns true in exactly one of them,
// the last to arrive, which then sees every other block's partial (the
// fence before the ticket and after it) and puts the ticket back to 0
// for the next launch on the stream.  An integer atomic: the order of
// the float sums never depends on which block is last.
__device__ __forceinline__ bool last_block(int* ticket, int n, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(ticket, 1);
    *flag = t == n - 1;
    if (t == n - 1) *ticket = 0;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// raise the kernel's dynamic shared memory limit, once per device
template <typename K>
inline bool allow_smem(K kernel, int bytes, int* done) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  if (dev < 16 && done[dev] >= bytes) return true;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return false;
  if (dev < 16) done[dev] = bytes;
  return true;
}

}  // namespace shortq
}  // namespace fa
