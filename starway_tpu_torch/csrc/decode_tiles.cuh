// The tile loop shared by the dense and the paged decode-attention kernels
// (decode_attention.cu, paged_attention.cu): one block attends a tile of
// at most kRowTile query rows of one (batch row, kv head) against its
// share of the live 32-key tiles, with an online softmax in float32, and
// writes an unnormalised partial (o, m, l); decode_combine_kernel merges
// the partials of the split over T.  The kernels differ only in how a key
// row's address is found, which the `Rows` functor gives: a contiguous
// cache row (DenseRows) or a page of a pool through a block table
// (PagedRows).
//
// Query rows are packed r = rep * C + ci (row r sits at position
// pos + r % C).  A row tile reads only the keys its own rows can see:
// keys up to pos + (its largest ci) and, with a window, from
// pos + (its smallest ci) - window + 1.  Rows past the live keys of a tile
// are never read (zero-filled), so the key rows of a pool page past the
// cursor, or a table entry past it, are never touched.
//
// Everything sits in an anonymous namespace: each source that includes
// this header gets its own copies of the kernels.
#pragma once

#include "common.cuh"

namespace {

constexpr int kBK = 32;        // keys per tile: one per lane in the softmax
constexpr int kThreads = 128;  // four warps
constexpr int kRowTile = 64;   // query rows per block (a grid axis above)

// Row index of key position kp in a contiguous [B * Hkv, T, D] cache.
struct DenseRows {
  size_t base;  // (batch row * Hkv + kv head) * T
  __device__ __forceinline__ size_t operator()(int kp) const {
    return base + kp;
  }
};

// Row index of key position kp in a pool [n_pages, Hkv, page, D]: page
// kp / page of the slot is pool page table[kp / page].
struct PagedRows {
  const int* __restrict__ table;  // this slot's [max_pages] page ids
  int page;
  int hkv;
  int head;
  __device__ __forceinline__ size_t operator()(int kp) const {
    const int i = kp / page;
    return (static_cast<size_t>(table[i]) * hkv + head) * page +
           (kp - i * page);
  }
};

// Load `n` valid key rows (of kBK, from position kt) into float shared
// memory (row stride `stride`), zero-filling the rest, with 16-byte loads.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          const Rows& key_row, int kt,
                                          int n) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16 bytes
  constexpr int kVecRow = D / kPer;     // 16-byte vectors per row
  constexpr int kVecs = kBK * kVecRow;
  constexpr int kIters = (kVecs + kThreads - 1) / kThreads;
  uint4 buf[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const int row = c / kVecRow;
    buf[it] = make_uint4(0, 0, 0, 0);
    if (c < kVecs && row < n)
      buf[it] = reinterpret_cast<const uint4*>(
          src + key_row(kt + row) * D)[c - row * kVecRow];
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = threadIdx.x + it * kThreads;
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
template <typename TQ, typename TKV, int D, typename Rows>
__device__ __forceinline__ void attend_rows(
    const TQ* __restrict__ qb, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const Rows& key_row, int pos,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, size_t part, int rows, int tile_rows,
    int n_q, int t_len, int window, float sm_scale) {
  constexpr int DP = D + 1;  // padded key rows: conflict-free score loop
  extern __shared__ float smem[];
  float* q_s = smem;                     // [tile_rows][D]
  float* acc = q_s + tile_rows * D;      // [tile_rows][D]
  float* k_s = acc + tile_rows * D;      // [kBK][D + 1]
  float* v_s = k_s + kBK * DP;           // [kBK][D]
  float* p_s = v_s + kBK * D;            // [tile_rows][kBK]
  float* m_s = p_s + tile_rows * kBK;    // [tile_rows]
  float* l_s = m_s + tile_rows;          // [tile_rows]
  float* c_s = l_s + tile_rows;          // [tile_rows]
  float* ks_s = c_s + tile_rows;         // [kBK]
  float* vs_s = ks_s + kBK;              // [kBK]

  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int r0 = blockIdx.z * tile_rows;
  const int nr = min(tile_rows, rows - r0);  // rows of this tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool quant = k_scale != nullptr;

  const TQ* qt = qb + static_cast<size_t>(r0) * D;
  for (int i = tid; i < nr * D; i += kThreads) {
    q_s[i] = sw_to_float(qt[i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < nr; r += kThreads) {
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
  const int t_first = k_lo / kBK;
  const int n_tiles = max((k_end + kBK - 1) / kBK - t_first, 0);
  const int per = (n_tiles + n_split - 1) / n_split;
  const int my_first = t_first + split * per;
  const int my_end = min(t_first + n_tiles, my_first + per);
  __syncthreads();

  for (int tile = my_first; tile < my_end; ++tile) {
    const int kt = tile * kBK;
    const int n = min(kBK, k_end - kt);  // live key rows of the tile
    load_tile<TKV, D>(k_s, DP, k, key_row, kt, n);
    load_tile<TKV, D>(v_s, D, v, key_row, kt, n);
    if (quant && tid < kBK) {
      ks_s[tid] = tid < n ? k_scale[key_row(kt + tid)] : 0.f;
      vs_s[tid] = tid < n ? v_scale[key_row(kt + tid)] : 0.f;
    }
    __syncthreads();

    // Scores: a warp covers one row against the 32 keys of the tile.
    for (int r = warp; r < nr; r += kThreads / 32) {
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
      p_s[r * kBK + lane] = sw_round_to<TQ>(p);
    }
    __syncthreads();

    for (int i = tid; i < nr * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const float* pr = p_s + r * kBK;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < kBK; j += 4) {
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
  for (int i = tid; i < nr * D; i += kThreads) ob[i] = acc[i];
  for (int r = tid; r < nr; r += kThreads) {
    m_part[part * rows + r0 + r] = m_s[r];
    l_part[part * rows + r0 + r] = l_s[r];
  }
}

// Merge the n_split partials of row tile blockIdx.y of each (batch row,
// kv head) and normalise:
// out = sum_s o_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30).
template <typename TQ>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, TQ* __restrict__ out, int n_split,
    int rows, int tile_rows, int d) {
  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * tile_rows;
  const int nr = min(tile_rows, rows - r0);
  const size_t p0 = static_cast<size_t>(bh) * n_split;
  for (int j = threadIdx.x; j < nr * d; j += kThreads) {
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
    out[static_cast<size_t>(bh) * rows * d + i] =
        sw_from_float<TQ>(o / fmaxf(l, 1e-30f));
  }
}

inline int row_tile(int rows) { return rows < kRowTile ? rows : kRowTile; }

// Shared memory bytes of one block of `tile_rows` query rows.
inline size_t smem_bytes(int tile_rows, int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(tile_rows) * d + kBK * (d + 1) + kBK * d +
          static_cast<size_t>(tile_rows) * kBK + 3 * tile_rows + 2 * kBK);
}

// The combine launch after a partial kernel over `bh` (batch row, kv
// head) pairs; returns cudaGetLastError() after both launches.
template <typename TQ>
int launch_combine(const float* o_part, const float* m_part,
                   const float* l_part, void* out, int bh, int n_split,
                   int rows, int d, cudaStream_t st) {
  const int tr = row_tile(rows);
  decode_combine_kernel<TQ><<<dim3(bh, (rows + tr - 1) / tr), kThreads, 0,
                              st>>>(o_part, m_part, l_part,
                                    static_cast<TQ*>(out), n_split, rows, tr,
                                    d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
