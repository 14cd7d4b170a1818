// The tiles of the flash-attention kernels (csrc/flash_fwd.cu,
// csrc/flash_bwd.cu): one tile size for q and kv tiles, the visibility and
// liveness tests in global coordinates, and the tensor-core kernels'
// staging of bf16 tiles in shared memory (also the decode kernels',
// csrc/decode_tiles.cuh).  Everything sits in an anonymous
// namespace: each source that includes this gets its own copy.
#pragma once

#include "common.cuh"
#include "ptx.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
static_assert(kBQ == kBK, "one tile size serves q and kv tiles alike");

// Is key ``kp`` visible from query ``qp`` (global coordinates)?
__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  if (!causal) return true;
  return qp >= kp && (window <= 0 || kp > qp - window);
}

// Is the [kBQ x kBK] tile at global (q_glob, k_glob) live?  The TPU
// kernels' liveness tests (pallas_attention.py _bwd_dkv_kernel and
// _bwd_dq_kernel; _fwd_kernel's and _partial_kernel's are the same).
__device__ __forceinline__ bool tile_live(int q_glob, int k_glob, int causal,
                                          int window) {
  if (!causal) return true;
  bool live = q_glob + kBQ - 1 >= k_glob;
  if (window > 0) live = live && k_glob + kBK - 1 > q_glob - window;
  return live;
}

// ------------------------------------------------------ bfloat16, mma.sync

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps of 16 stationary rows each
constexpr int kPad = 8;           // bf16 of padding at the end of a row
constexpr float kLog2e = 1.4426950408889634f;

// A [ROWS][D] tile of ``src`` (rows from ``r0``, ``n_rows`` valid) into
// shared memory with row stride D + kPad, by 16-byte cp.async; rows past
// the end are zero-filled and not read.
template <int D, int ROWS = kBQ>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int r0, int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool ok = r0 + r < n_rows;
    cp_async16(smem_u32(dst + r * (D + kPad) + c),
               ok ? src + static_cast<size_t>(r0 + r) * D + c : src,
               ok ? 16 : 0);
  }
}

// Does the tile need element masks: ragged ends, the diagonal, the band
// edge?  Otherwise every (q, k) pair of it is visible.
__device__ __forceinline__ bool tile_edge(int q0, int s_len, int q_glob,
                                          int k0, int kv_len, int k_glob,
                                          int causal, int window) {
  if (q0 + kBQ > s_len || k0 + kBK > kv_len) return true;
  if (!causal) return false;
  if (q_glob < k_glob + kBK - 1) return true;
  return window > 0 && q_glob + kBQ - 1 - k_glob >= window;
}

// The live range [*lo, *hi] of the tiles walked by a block whose
// stationary tile is at ``fixed_glob``: q tiles (pass A, ``walk_q``) or
// kv tiles (pass B and the forward), each of ``n`` tiles at ``off + 64 i``.
// Empty when *hi < *lo: a block whose rows all precede the kv shard.
__device__ __forceinline__ void live_range(int n, int off, int fixed_glob,
                                           bool walk_q, int causal,
                                           int window, int* lo, int* hi) {
  *lo = n;
  *hi = -1;
  for (int i = 0; i < n; ++i) {
    const int glob = off + i * kBQ;
    const bool live = walk_q ? tile_live(glob, fixed_glob, causal, window)
                             : tile_live(fixed_glob, glob, causal, window);
    if (live) {
      *lo = min(*lo, i);
      *hi = i;
    }
  }
}

template <typename TO>
__device__ __forceinline__ void store2(TO* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

}  // namespace
