// The tile loops shared by the dense and the paged decode-attention kernels
// (decode_attention.cu, paged_attention.cu).  The kernels differ only in how
// a key row's address is found, which the `Rows` functor gives: a
// contiguous cache row (DenseRows) or a page of a pool through a block
// table (PagedRows).
//
// Query rows are packed r = rep * C + ci (row r sits at position
// pos + r % C).  A tile of query rows reads only the keys its own rows can
// see: keys up to pos + (its largest ci) and, with a window, from
// pos + (its smallest ci) - window + 1.  Key rows past the live keys of a
// tile are never read (zero-filled), so the key rows of a pool page past
// the cursor, or a table entry past it, are never touched.
//
// bfloat16 queries: the tensor-core loop (attend_mma; one launch a call).
// - K and V tiles of kKeys = 64 keys stream into a ring of 2 stages by
//   16-byte cp.async.cg: bf16 rows padded to D + 8 elements as in
//   flash_tiles.cuh, int8 rows to D + 16 bytes (one byte an element), with
//   a tile's k and v scales beside it.  While a stage computes, the next
//   is in flight.
// - s = q k^T and acc += p v on mma.sync.m16n8k16 (bf16 in, float32
//   accumulators); the score tile, the online softmax (exp2, m in natural
//   units, masked scores -inf) and p stay in registers, and p is packed
//   to bf16 straight from the accumulator layout into the A fragments of
//   p v, as in csrc/flash_fwd.cu.  bf16 B fragments come by ldmatrix (K)
//   and ldmatrix.trans (V).  int8 fragments are widened in registers
//   (widen2): K's with the head dimension permuted inside each k16 step
//   (q's A fragments read the same permutation), so that a thread's four
//   values are one 32-bit load; V's with the output columns permuted in
//   groups of four n-tiles, so that one 32-bit load of a key row serves
//   four n-tiles.  The epilogue writes the columns back in order.
// - Two regimes (ops/decode.py decode_plan, from rows = n_rep * C):
//   decode (rows <= 16: one m16 tile holds them all) splits each stage's
//   64 keys over the four warps, 16 each, and merges the warps' (o, m, l)
//   in shared memory; ingest (rows > 16) takes 64-row tiles of 16 rows a
//   warp, each warp against all 64 keys: csrc/flash_fwd.cu's loop at query
//   offset pos.
// - The split over T: the live tiles of a row tile are dealt to the
//   n_split blocks of one thread block cluster (gridDim.x), each share
//   computed on the device from pos; a block whose share is empty emits
//   the identity (m NEG_BIG, l 0, acc 0).  After the loop each block
//   leaves its partial (float32 o, m, l) in its shared memory, and the
//   cluster merges them over distributed shared memory in split order
//   (weight exp(m_z - M); an identity weighs 0), normalises by max(l,
//   1e-30) and writes q's dtype.  No partial reaches device memory, and
//   the sums run in a fixed order: two calls give identical bits.
// - Paged addressing: a thread resolves a key row's page once a page, not
//   once a vector (a shift where the page is a power of two); where a page
//   holds the whole tile, that is once a tile.
//
// float32 queries (the parity runs): the FMA loop (attend_rows), one
// block per (row tile, split) writing unnormalised float32 partials that
// decode_combine_kernel merges: scores, softmax and p @ v on the FMA
// units from float32 tiles in shared memory.  TF32 tensor cores would not
// hold the float32 paths' 1e-5.
//
// Everything sits in an anonymous namespace: each source that includes
// this header gets its own copies of the kernels.
#pragma once

#include <cooperative_groups.h>
#include <math_constants.h>

#include "flash_tiles.cuh"

namespace {

// Row index of key position kp in a contiguous [B * Hkv, T, D] cache.
struct DenseRows {
  size_t base;  // (batch row * Hkv + kv head) * T
  __device__ __forceinline__ size_t operator()(int kp) const {
    return base + kp;
  }
};

// Row index of key position kp in a pool [n_pages, Hkv, page, D]: page
// kp / page of the slot is pool page table[kp / page].  shift: log2(page)
// where page is a power of two, else -1.
struct PagedRows {
  const int* __restrict__ table;  // this slot's [max_pages] page ids
  int page;
  int shift;
  int hkv;
  int head;
  __device__ __forceinline__ int page_of(int kp) const {
    return shift >= 0 ? kp >> shift : kp / page;
  }
  __device__ __forceinline__ size_t operator()(int kp) const {
    const int i = page_of(kp);
    return (static_cast<size_t>(table[i]) * hkv + head) * page +
           (kp - i * page);
  }
};

// A thread's walk over increasing key positions: DenseRows as they are;
// PagedRows reading a table entry only when the page changes.
template <typename Rows>
struct RowCursor {
  const Rows& rows;
  __device__ __forceinline__ size_t operator()(int kp) { return rows(kp); }
};
template <>
struct RowCursor<PagedRows> {
  const PagedRows& rows;
  int last = -1;
  size_t first = 0;  // row index of the first key of page `last`
  __device__ __forceinline__ size_t operator()(int kp) {
    const int i = rows.page_of(kp);
    if (i != last) {
      last = i;
      first = (static_cast<size_t>(rows.table[i]) * rows.hkv + rows.head) *
              rows.page;
    }
    return first + (kp - i * rows.page);
  }
};

// ---------------------------------------------------------------- float32

constexpr int kFmaKeys = 32;     // keys per tile: one per lane in the softmax
constexpr int kFmaThreads = 128;  // four warps
constexpr int kFmaRows = 64;     // query rows per block (a grid axis above)

// Load `n` valid key rows (of kFmaKeys, from position kt) into float shared
// memory (row stride `stride`), zero-filling the rest, with 16-byte loads.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          const Rows& key_row, int kt,
                                          int n) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16 bytes
  constexpr int kVecRow = D / kPer;     // 16-byte vectors per row
  constexpr int kVecs = kFmaKeys * kVecRow;
  constexpr int kIters = (kVecs + kFmaThreads - 1) / kFmaThreads;
  uint4 buf[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = threadIdx.x + it * kFmaThreads;
    const int row = c / kVecRow;
    buf[it] = make_uint4(0, 0, 0, 0);
    if (c < kVecs && row < n)
      buf[it] = reinterpret_cast<const uint4*>(
          src + key_row(kt + row) * D)[c - row * kVecRow];
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = threadIdx.x + it * kFmaThreads;
    if (c >= kVecs) break;
    const int row = c / kVecRow;
    const int col = (c - row * kVecRow) * kPer;
    const T* e = reinterpret_cast<const T*>(&buf[it]);
#pragma unroll
    for (int x = 0; x < kPer; ++x)
      dst[row * stride + col + x] = sw_to_float(e[x]);
  }
}

// One block's work: row tile blockIdx.z of the (batch row, kv head) whose
// queries start at `qb`, against split blockIdx.y of gridDim.y over the
// tile's live key tiles.  Partials: o [.., n_split, rows, D], m/l
// [.., n_split, rows] at index `part` = (batch row * Hkv + kv head) *
// n_split + split.  k_scale/v_scale: int8 caches (else nullptr), indexed
// by the key row.
template <int D, typename TKV, typename Rows>
__device__ __forceinline__ void attend_rows(
    const float* __restrict__ qb, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const Rows& key_row, int pos,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, size_t part, int rows, int tile_rows,
    int n_q, int t_len, int window, float sm_scale) {
  constexpr int DP = D + 1;  // padded key rows: conflict-free score loop
  extern __shared__ float smem[];
  float* q_s = smem;                     // [tile_rows][D]
  float* acc = q_s + tile_rows * D;      // [tile_rows][D]
  float* k_s = acc + tile_rows * D;      // [kFmaKeys][D + 1]
  float* v_s = k_s + kFmaKeys * DP;      // [kFmaKeys][D]
  float* p_s = v_s + kFmaKeys * D;       // [tile_rows][kFmaKeys]
  float* m_s = p_s + tile_rows * kFmaKeys;  // [tile_rows]
  float* l_s = m_s + tile_rows;          // [tile_rows]
  float* c_s = l_s + tile_rows;          // [tile_rows]
  float* ks_s = c_s + tile_rows;         // [kFmaKeys]
  float* vs_s = ks_s + kFmaKeys;         // [kFmaKeys]

  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int r0 = blockIdx.z * tile_rows;
  const int nr = min(tile_rows, rows - r0);  // rows of this tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool quant = k_scale != nullptr;

  const float* qt = qb + static_cast<size_t>(r0) * D;
  for (int i = tid; i < nr * D; i += kFmaThreads) {
    q_s[i] = qt[i];
    acc[i] = 0.f;
  }
  for (int r = tid; r < nr; r += kFmaThreads) {
    m_s[r] = SW_NEG_BIG;
    l_s[r] = 0.f;
  }

  // The positions this tile's rows sit at: all C of them, unless the
  // tile lies inside one query head's run of C rows.
  int ci_lo = 0, ci_hi = n_q - 1;
  if (r0 / n_q == (r0 + nr - 1) / n_q) {
    ci_lo = r0 % n_q;
    ci_hi = (r0 + nr - 1) % n_q;
  }
  // This block's share of the tile's live key tiles.
  const int k_end = min(pos + ci_hi + 1, t_len);  // keys < k_end
  const int k_lo = window > 0 ? max(pos + ci_lo - window + 1, 0) : 0;
  const int t_first = k_lo / kFmaKeys;
  const int n_tiles = max((k_end + kFmaKeys - 1) / kFmaKeys - t_first, 0);
  const int per = (n_tiles + n_split - 1) / n_split;
  const int my_first = t_first + split * per;
  const int my_end = min(t_first + n_tiles, my_first + per);
  __syncthreads();

  for (int tile = my_first; tile < my_end; ++tile) {
    const int kt = tile * kFmaKeys;
    const int n = min(kFmaKeys, k_end - kt);  // live key rows of the tile
    load_tile<TKV, D>(k_s, DP, k, key_row, kt, n);
    load_tile<TKV, D>(v_s, D, v, key_row, kt, n);
    if (quant && tid < kFmaKeys) {
      ks_s[tid] = tid < n ? k_scale[key_row(kt + tid)] : 0.f;
      vs_s[tid] = tid < n ? v_scale[key_row(kt + tid)] : 0.f;
    }
    __syncthreads();

    // Scores: a warp covers one row against the 32 keys of the tile.
    for (int r = warp; r < nr; r += kFmaThreads / 32) {
      const float* qr = q_s + r * D;
      const float* kr = k_s + lane * DP;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        s0 = fmaf(qr[c], kr[c], s0);
        s1 = fmaf(qr[c + 1], kr[c + 1], s1);
        s2 = fmaf(qr[c + 2], kr[c + 2], s2);
        s3 = fmaf(qr[c + 3], kr[c + 3], s3);
      }
      float s = (s0 + s1) + (s2 + s3);
      s = quant ? s * (ks_s[lane] * sm_scale) : s * sm_scale;
      const int kp = kt + lane;
      const int qp = pos + (r0 + r) % n_q;
      bool keep = lane < n && kp <= qp;
      if (window > 0) keep = keep && kp > qp - window;
      s = keep ? s : SW_NEG_BIG;

      // Online softmax for this row.
      float mx = s;
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float p = s > SW_NEG_BIG / 2 ? expf(s - m_new) : 0.f;
      float sum = p;
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
      if (quant) p *= vs_s[lane];  // after l: l excludes the v scale
      p_s[r * kFmaKeys + lane] = p;
    }
    __syncthreads();

    for (int i = tid; i < nr * D; i += kFmaThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const float* pr = p_s + r * kFmaKeys;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < kFmaKeys; j += 4) {
        a0 = fmaf(pr[j], v_s[j * D + c], a0);
        a1 = fmaf(pr[j + 1], v_s[(j + 1) * D + c], a1);
        a2 = fmaf(pr[j + 2], v_s[(j + 2) * D + c], a2);
        a3 = fmaf(pr[j + 3], v_s[(j + 3) * D + c], a3);
      }
      acc[i] = acc[i] * c_s[r] + ((a0 + a1) + (a2 + a3));
    }
    __syncthreads();
  }

  float* ob = o_part + (part * rows + r0) * D;
  for (int i = tid; i < nr * D; i += kFmaThreads) ob[i] = acc[i];
  for (int r = tid; r < nr; r += kFmaThreads) {
    m_part[part * rows + r0 + r] = m_s[r];
    l_part[part * rows + r0 + r] = l_s[r];
  }
}

// Merge the n_split partials of row tile blockIdx.y of each (batch row,
// kv head) and normalise:
// out = sum_s o_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30).
__global__ void __launch_bounds__(kFmaThreads) decode_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, float* __restrict__ out, int n_split,
    int rows, int tile_rows, int d) {
  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * tile_rows;
  const int nr = min(tile_rows, rows - r0);
  const size_t p0 = static_cast<size_t>(bh) * n_split;
  for (int j = threadIdx.x; j < nr * d; j += kFmaThreads) {
    const int i = r0 * d + j;  // index inside this (batch row, kv head)
    const int r = i / d;
    float mx = SW_NEG_BIG;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, m_part[(p0 + s) * rows + r]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(m_part[(p0 + s) * rows + r] - mx);
      l += l_part[(p0 + s) * rows + r] * w;
      o += o_part[(p0 + s) * rows * d + i] * w;
    }
    out[static_cast<size_t>(bh) * rows * d + i] = o / fmaxf(l, 1e-30f);
  }
}

inline int fma_row_tile(int rows) {
  return rows < kFmaRows ? rows : kFmaRows;
}

// Shared memory bytes of one FMA block of `tile_rows` query rows.
inline size_t fma_smem_bytes(int tile_rows, int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(tile_rows) * d + kFmaKeys * (d + 1) +
          kFmaKeys * d + static_cast<size_t>(tile_rows) * kFmaKeys +
          3 * tile_rows + 2 * kFmaKeys);
}

// The combine launch after a partial kernel over `bh` (batch row, kv
// head) pairs; returns cudaGetLastError() after both launches.
inline int launch_combine(const float* o_part, const float* m_part,
                          const float* l_part, void* out, int bh,
                          int n_split, int rows, int d, cudaStream_t st) {
  const int tr = fma_row_tile(rows);
  decode_combine_kernel<<<dim3(bh, (rows + tr - 1) / tr), kFmaThreads, 0,
                          st>>>(o_part, m_part, l_part,
                                static_cast<float*>(out), n_split, rows, tr,
                                d);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ bfloat16, mma.sync

namespace cg = cooperative_groups;

constexpr int kKeys = 64;         // keys a stage
constexpr int kMaxSplits = 16;    // a non-portable cluster (8 at D = 256)
constexpr int kSlots = 64;        // partial rows a block leaves: 4 warps x 16

// One pipeline stage: K and V tiles of kKeys rows (bf16 rows of D + kPad
// elements; int8 rows of D + 16 bytes, so that a warp's 32-bit fragment
// loads fall in 32 distinct banks), then for int8 the tile's k and v
// scales.
template <typename TKV, int D>
struct Stage {
  static constexpr bool kInt8 = sizeof(TKV) == 1;
  static constexpr int kRowBytes = kInt8 ? D + 16 : 2 * (D + kPad);
  static constexpr int kChunks = D * static_cast<int>(sizeof(TKV)) / 16;
  static constexpr int kTileBytes = kKeys * kRowBytes;
  static constexpr int kBytes = 2 * kTileBytes + (kInt8 ? 8 * kKeys : 0);
};

// A block's shared memory: its q rows (bf16, D + kPad a row), then the
// ring of stages, which the float32 partials (o [64][D + 4], m [64], l
// [64]) take over after the loop.  Two stages: on the H100 three, four
// and six ran no faster (a block's tile loop, not the copies' latency,
// sets its pace: int8 tiles, half the bytes, took as long), and two let
// the decode regime's blocks (72 KB at D = 128) fit three an SM.
template <typename TKV, int D, bool kDecode>
struct MmaShape {
  static constexpr int kRows = kDecode ? 16 : 64;  // q rows a block
  static constexpr int kStages = 2;  // the loop's prefetch assumes 2
  static constexpr int kQBytes = kRows * (D + kPad) * 2;
  static constexpr int kOLd = D + 4;
  static constexpr int kPartBytes = 4 * (kSlots * kOLd + 2 * kSlots);
  static constexpr int kRing = kStages * Stage<TKV, D>::kBytes;
  static constexpr size_t kSmem =
      kQBytes + (kRing > kPartBytes ? kRing : kPartBytes);
};

// Copy the K and V rows of keys kt .. kt + n - 1 (and int8 scales) into a
// stage by cp.async, zero-filling its other rows without reading them.
template <typename TKV, int D, typename Rows>
__device__ __forceinline__ void copy_stage(
    unsigned char* stage, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const Rows& key_row, int kt, int n) {
  using St = Stage<TKV, D>;
  constexpr int kPer = 16 / sizeof(TKV);  // elements a chunk
  RowCursor<Rows> row_of{key_row};
  const uint32_t base = smem_u32(stage);
  for (int i = threadIdx.x; i < kKeys * St::kChunks; i += kMmaThreads) {
    const int r = i / St::kChunks;
    const int c = i - r * St::kChunks;
    const bool ok = r < n;
    const size_t off = ok ? row_of(kt + r) * D + c * kPer : 0;
    const uint32_t dst = base + r * St::kRowBytes + c * 16;
    cp_async16(dst, k + off, ok ? 16 : 0);
    cp_async16(dst + St::kTileBytes, v + off, ok ? 16 : 0);
  }
  if constexpr (St::kInt8) {
    const int t = threadIdx.x;  // 128 threads: 64 k scales, then 64 v
    const int r = t & (kKeys - 1);
    const bool ok = r < n;
    const float* src = t < kKeys ? k_scale : v_scale;
    cp_async4(base + 2 * St::kTileBytes + 4 * t,
              src + (ok ? row_of(kt + r) : 0), ok ? 4 : 0);
  }
}

// G bytes (2 or 4) of shared memory as the low bytes of a word.
template <int G>
__device__ __forceinline__ uint32_t ld_bytes(const unsigned char* p) {
  if constexpr (G == 4) return *reinterpret_cast<const uint32_t*>(p);
  return *reinterpret_cast<const uint16_t*>(p);
}

// Column of the head dimension that accumulator n-tile j, column c holds:
// in order for bf16 V; for int8 V, n-tiles are grouped G at a time and a
// group's 8 G columns interleave (see the p v loop).
template <bool kInt8, int G>
__device__ __forceinline__ int acc_col(int j, int c) {
  if constexpr (!kInt8) return 8 * j + c;
  return 8 * G * (j / G) + G * c + j % G;
}

// The tensor-core tile loop of one block: row tile blockIdx.y (of
// MmaShape::kRows rows) of the (batch row, kv head) whose queries start at
// `qb` and whose output rows start at `ob`, against split blockIdx.x of the
// cluster's gridDim.x over the tile's live key tiles; the cluster merges
// the splits and writes the output.  k_scale/v_scale: int8 caches (else
// nullptr), indexed by the key row.
template <typename TKV, int D, bool kDecode, typename Rows>
__device__ __forceinline__ void attend_mma(
    const bf16* __restrict__ qb, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const Rows& key_row, int pos,
    bf16* __restrict__ ob, int rows, int n_q, int t_len, int window,
    float sm_scale) {
  using St = Stage<TKV, D>;
  using Sh = MmaShape<TKV, D, kDecode>;
  constexpr bool kInt8 = St::kInt8;
  constexpr int RT = Sh::kRows;
  constexpr int S = Sh::kStages;
  constexpr int LD = D + kPad;           // bf16 elements a q, K or V row
  constexpr int RB = St::kRowBytes;      // bytes a K or V row
  constexpr int KW = kDecode ? 16 : kKeys;  // keys a warp takes of a stage
  constexpr int KD = D / 16;             // k-steps of s = q k^T
  constexpr int NT = D / 8;              // n-tiles of the accumulator
  constexpr int NS = KW / 8;             // n-tiles of a warp's scores
  constexpr int G = NT < 4 ? NT : 4;     // int8 V: n-tiles a load serves
  constexpr bool kQRegs = D <= 128;      // q's A fragments in registers
  constexpr int OLD = Sh::kOLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + Sh::kQBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t4 = lane & 3;  // accumulator columns 2 t4, 2 t4 + 1
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int r0 = blockIdx.y * RT;
  const int nr = min(RT, rows - r0);

  // The positions this tile's rows sit at: all C of them, unless the
  // tile lies inside one query head's run of C rows.
  int ci_lo = 0, ci_hi = n_q - 1;
  if (r0 / n_q == (r0 + nr - 1) / n_q) {
    ci_lo = r0 % n_q;
    ci_hi = (r0 + nr - 1) % n_q;
  }
  // This block's share of the tile's live key tiles: split z of n takes
  // tiles [z T / n, (z + 1) T / n) of the T live ones.
  const int k_end = min(pos + ci_hi + 1, t_len);  // keys < k_end
  const int k_lo = window > 0 ? max(pos + ci_lo - window + 1, 0) : 0;
  const int t_first = k_lo / kKeys;
  const int n_tiles = max((k_end + kKeys - 1) / kKeys - t_first, 0);
  const int my_first = t_first + split * n_tiles / n_split;
  const int n_items = t_first + (split + 1) * n_tiles / n_split - my_first;

  const int row0 = kDecode ? 0 : 16 * warp;  // the warp's q rows
  const int key0 = kDecode ? 16 * warp : 0;  // the warp's keys of a stage

  auto prefetch = [&](int item) {
    const int kt = (my_first + item) * kKeys;
    copy_stage<TKV, D>(ring + (item % S) * St::kBytes, k, v, k_scale,
                       v_scale, key_row, kt, min(kKeys, k_end - kt));
  };
  if (n_items > 0) {
    load_tile_async<D, RT>(q_s, qb, r0, rows);
    prefetch(0);
  }
  cp_async_commit();

  // This lane's ldmatrix row addresses: the A operand (q rows of the
  // warp), B stored [n][k] (K in s = q k^T) and B stored [k][n] (.trans:
  // V in p v).
  const int a_row = row0 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int bn_row = (lane & 7) + ((lane >> 4) << 3);
  const int bn_col = ((lane >> 3) & 1) * 8;
  const int bt_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bt_col = (lane >> 4) * 8;
  // q's A fragment of k-step kk.  For int8 K the step's 16 columns are
  // permuted: a thread's columns {2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9} are
  // 4 t4 .. 4 t4 + 3, one 8-byte load a row here, one 32-bit load of K.
  auto q_frag = [&](uint32_t(&a)[4], int kk) {
    if constexpr (kInt8) {
      const bf16* p = q_s + (row0 + g) * LD + kk * 16 + 4 * t4;
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      const uint2 y = *reinterpret_cast<const uint2*>(p + 8 * LD);
      a[0] = x.x;
      a[1] = y.x;
      a[2] = x.y;
      a[3] = y.y;
    } else {
      ldsm_x4(a, smem_u32(q_s + a_row * LD + kk * 16 + a_col));
    }
  };

  uint32_t qa[kQRegs ? KD : 1][4];
  float acc[NT][4];  // rows row0 + g (+ 8) of the tile
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // Rows g and g + 8: the running max of the scaled scores (natural
  // units) and this thread's part of the row sum.
  float m_row[2] = {SW_NEG_BIG, SW_NEG_BIG};
  float l_row[2] = {0.f, 0.f};
  const float scale_l2 = sm_scale * kLog2e;

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) prefetch(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) q_frag(qa[kk], kk);
      }
    }
    const unsigned char* st = ring + (it % S) * St::kBytes;
    const float* ks_s = reinterpret_cast<const float*>(st + 2 * St::kTileBytes);
    const float* vs_s = ks_s + kKeys;
    const int kt = (my_first + it) * kKeys;

    float s[NS][4];  // [key n-tile][fragment]: raw q . k
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qa[kk][r];
      } else {
        q_frag(a, kk);
      }
      if constexpr (kInt8) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              st + (key0 + 8 * j + g) * RB + kk * 16 + 4 * t4);
          mma(s[j], a, widen2(w, w, 0x0100u), widen2(w, w, 0x0302u));
        }
      } else {
        const bf16* kb = reinterpret_cast<const bf16*>(st);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bk[4];
          ldsm_x4(bk, smem_u32(kb + (key0 + jp * 16 + bn_row) * LD +
                               kk * 16 + bn_col));
          mma(s[2 * jp], a, bk[0], bk[1]);
          mma(s[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
    }
    if constexpr (kInt8) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] *= ks_s[key0 + 8 * j + 2 * t4 + (e & 1)];
    }
    // Element masks only where the tile is not wholly visible to every
    // row: ragged end, the rows' diagonal, the window's edge.
    const bool edge = !(kt + kKeys <= k_end && kt + kKeys - 1 <= pos + ci_lo &&
                        (window <= 0 || kt > pos + ci_hi - window));
    if (edge) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kt + key0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = pos + (r0 + row0 + g + (e >> 1) * 8) % n_q;
          bool keep = kp < k_end && kp <= qp;
          if (window > 0) keep = keep && kp > qp - window;
          if (!keep) s[j][e] = -CUDART_INF_F;
        }
    }

    // Online softmax of rows g (h = 0) and g + 8 (h = 1); s becomes p.
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[h], mx * sm_scale);
      // A row that sees no key of this tile keeps p exactly 0.
      const float m_l2 = fmaxf(m_new, SW_NEG_BIG / 2) * kLog2e;
      corr[h] = exp2f((m_row[h] - m_new) * kLog2e);
      m_row[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], scale_l2, -m_l2));
          sum += s[j][e];
        }
      l_row[h] = l_row[h] * corr[h] + sum;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    if constexpr (kInt8) {  // after l: l excludes the v scale
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] *= vs_s[key0 + 8 * j + 2 * t4 + (e & 1)];
    }
    // Score n-tiles 2 kq and 2 kq + 1 are k-step kq of p v.
    uint32_t pa[KW / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      pa[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
    }
    const unsigned char* vt = st + St::kTileBytes;
#pragma unroll
    for (int kq = 0; kq < KW / 16; ++kq) {
      if constexpr (kInt8) {
        // Keys 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 of the step: G bytes of
        // each row at columns 8 G J + G g .. + G - 1 are column g of
        // n-tiles G J .. G J + G - 1 (acc_col).
        const unsigned char* vr =
            vt + (key0 + kq * 16 + 2 * t4) * RB + G * g;
#pragma unroll
        for (int J = 0; J < NT / G; ++J) {
          const unsigned char* c = vr + 8 * G * J;
          const uint32_t w0 = ld_bytes<G>(c);
          const uint32_t w1 = ld_bytes<G>(c + RB);
          const uint32_t w8 = ld_bytes<G>(c + 8 * RB);
          const uint32_t w9 = ld_bytes<G>(c + 9 * RB);
#pragma unroll
          for (int jj = 0; jj < G; ++jj) {
            const uint32_t sel = jj | ((4 + jj) << 8);
            mma(acc[G * J + jj], pa[kq], widen2(w0, w1, sel),
                widen2(w8, w9, sel));
          }
        }
      } else {
        const bf16* vb = reinterpret_cast<const bf16*>(vt);
        const int row = (key0 + kq * 16 + bt_row) * LD + bt_col;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bv[4];
          ldsm_x4_t(bv, smem_u32(vb + row + np * 16));
          mma(acc[2 * np], pa[kq], bv[0], bv[1]);
          mma(acc[2 * np + 1], pa[kq], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the next item's copy
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partials take it over

  // This block's partial: slot 16 warp + g (+ 8), columns in order.
  float* o_s = reinterpret_cast<float*>(ring);
  float* m_s = o_s + kSlots * OLD;
  float* l_s = m_s + kSlots;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];  // the row sum over the quad, in a fixed order
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int slot = 16 * warp + g + 8 * h;
    float* orow = o_s + slot * OLD;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      orow[acc_col<kInt8, G>(j, 2 * t4)] = acc[j][2 * h];
      orow[acc_col<kInt8, G>(j, 2 * t4 + 1)] = acc[j][2 * h + 1];
    }
    if (t4 == 0) {
      m_s[slot] = m_row[h];
      l_s[slot] = l;
    }
  }
  __syncthreads();
  constexpr int C4 = D / 4;  // float4 columns a row
  if constexpr (kDecode) {
    // The four warps' partials of rows 0..15 into slots 0..15, in warp
    // order.
    float m_mine = SW_NEG_BIG, l_mine = 0.f;
    for (int i = tid; i < 16 * C4; i += kMmaThreads) {
      const int r = i / C4;
      const int c = (i - r * C4) * 4;
      float mx = m_s[r];
#pragma unroll
      for (int w = 1; w < 4; ++w) mx = fmaxf(mx, m_s[16 * w + r]);
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float wt = exp2f((m_s[16 * w + r] - mx) * kLog2e);
        const float4 x =
            *reinterpret_cast<const float4*>(o_s + (16 * w + r) * OLD + c);
        o.x = fmaf(x.x, wt, o.x);
        o.y = fmaf(x.y, wt, o.y);
        o.z = fmaf(x.z, wt, o.z);
        o.w = fmaf(x.w, wt, o.w);
      }
      *reinterpret_cast<float4*>(o_s + r * OLD + c) = o;
    }
    if (tid < 16) {
      m_mine = m_s[tid];
#pragma unroll
      for (int w = 1; w < 4; ++w) m_mine = fmaxf(m_mine, m_s[16 * w + tid]);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        l_mine += l_s[16 * w + tid] *
                  exp2f((m_s[16 * w + tid] - m_mine) * kLog2e);
    }
    __syncthreads();
    if (tid < 16) {
      m_s[tid] = m_mine;
      l_s[tid] = l_mine;
    }
  }

  // The cluster's merge over its n_split partials, in split order.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial is in place
  for (int i = split * kMmaThreads + tid; i < nr * C4;
       i += n_split * kMmaThreads) {
    const int r = i / C4;
    const int c = (i - r * C4) * 4;
    float mz[kMaxSplits];
    float mx = SW_NEG_BIG;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < n_split) {
        mz[z] = *cluster.map_shared_rank(m_s + r, z);
        mx = z == 0 ? mz[z] : fmaxf(mx, mz[z]);
      }
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < n_split) {
        const float wt = exp2f((mz[z] - mx) * kLog2e);
        l = fmaf(*cluster.map_shared_rank(l_s + r, z), wt, l);
        const float4 x = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(o_s + r * OLD + c, z));
        o.x = fmaf(x.x, wt, o.x);
        o.y = fmaf(x.y, wt, o.y);
        o.z = fmaf(x.z, wt, o.z);
        o.w = fmaf(x.w, wt, o.w);
      }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* dst = ob + static_cast<size_t>(r0 + r) * D + c;
    store2<bf16>(dst, o.x * inv, o.y * inv);
    store2<bf16>(dst + 2, o.z * inv, o.w * inv);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// Launch a tensor-core decode kernel on `grid` (the splits along x, one
// thread block cluster each); returns the launch's error.
template <typename K, typename... Args>
int launch_cluster(K kernel, dim3 grid, size_t smem, cudaStream_t st,
                   Args... args) {
  sw_allow_smem(kernel, smem);
  if (grid.x > 8)
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The largest split a head size launches: a cluster of 16 blocks needs
// them on one GPC, which D = 256's blocks (one an SM) may not find.
inline int max_splits(int d) { return d <= 128 ? kMaxSplits : 8; }

}  // namespace
