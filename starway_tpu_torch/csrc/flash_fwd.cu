// GQA flash-attention forward: causal or not, kv padding, sliding window,
// global [q_offset, kv_offset] coordinates; and one ring step's
// unnormalised partial.
//
// Replaces the TPU kernels starway_tpu/ops/pallas_attention.py _fwd_kernel
// (with _mask_scores; called from _fwd_impl) and _partial_kernel (entry
// flash_partial, one ring step of parallel/ring_attention.py).
//
// What bounds it: operations.  A causal pass over S tokens does about
// 2 * S^2 * D multiply-adds per head against O(S * D) bytes, far above the
// card's ~295 FLOP/byte balance point at prompt lengths of a few hundred
// and more.  The design keeps the [S, S] score matrix out of device memory:
// one thread block per (batch * q head, 64-row q tile) walks the live
// 64-key kv tiles with the online softmax, and reads each tile once per q
// tile.  The kv head is h / n_rep, so the grouped cache is never expanded.
// Tiles past the causal diagonal or wholly below every row's window are
// neither read nor computed.  Scores, softmax statistics and the
// accumulator are float32; p is rounded to the input dtype before p @ v.
//
// Two epilogues share each tile loop:
// - the forward writes o = acc / l in the input dtype and the row
//   log-sum-exp lse [B, Hq, S] float32;
// - the partial writes the unnormalised partial of a ring step: acc [B,
//   Hq, S, D], m and l [B, Hq, S], all float32, the mergeable form of
//   ops/attention.py partial_attention.  A row that sees no key (a dead
//   block, or rows above the diagonal of a partly live one) emits the
//   identity (acc = 0, m = NEG_BIG, l = 0).  The TPU kernel carries no
//   band, so the JAX package runs windowed ring steps through its plain
//   path; this kernel takes the window as the forward does, so that no
//   ring step on the card runs the plain version.  The function computed
//   is the same.
//
// Liveness is decided in global coordinates (csrc/flash_tiles.cuh
// live_range), where the last live kv tile of a block can lie before the
// kv shard: such a block runs no tile at all.
//
// bfloat16 inputs at head sizes 16 and 32 (64 and 128 run
// csrc/flash_fwd_wgmma.cu): tensor cores (flash_fwd_mma_kernel,
// flash_partial_mma_kernel; one tile loop, flash_tiles_mma), the forward
// of FlashAttention-2 on mma.sync.m16n8k16 bf16 -> f32, as the backward's
// pass B (csrc/flash_bwd.cu) without dO and delta.  128 threads, 4 warps;
// each warp owns MT m-tiles of 16 query rows and all D columns of their
// accumulators, so a block holds a q tile of 64 MT rows: 64 or 128, as
// ops/flash.py fwd_q_rows plans from the shapes.  The taller tile halves
// what the kv tiles cost: each K/V tile staged from L2 serves 128 rows
// instead of 64 (at 64 rows a causal pass over S = 4096 reads ~2.2 GB
// from L2, ~3.3 TB/s at the time it takes); the shorter one keeps small
// and causally lopsided grids (an admission bucket up to 1024 tokens, the
// ring's diagonal block) from waiting on a few long blocks.  With one
// m-tile the warp's q rows stay in registers as the A fragments of s = q
// k^T (D / 16 x 4 registers); with two they are read from shared memory
// at each k-step, and the m-tiles' scores are formed one after the other,
// so that registers hold two accumulators (128 floats at D = 128) and one
// score tile while V's fragments serve both.  The kv tiles are staged by
// 16-byte cp.async.cg into two stages (the next live tile's copy is in
// flight while this one is computed; rows past the end zero-filled), rows
// padded to D + 8 bf16 so that ldmatrix's eight rows fall in distinct
// 16-byte bank groups.  K's B fragments come by ldmatrix, V's by
// ldmatrix.trans.  A warp's 16 x 64 score tile stays in registers (32
// floats a thread): masks apply only on tiles that cross the diagonal,
// the band edge or the array end (flash_tiles.cuh tile_edge), a masked
// score is -inf, a row's max is reduced over its quad by __shfl_xor_sync,
// and p = 2^(s * scale * log2 e - m * log2 e) with m kept in natural units
// (so m and lse are emitted as they are, m exactly NEG_BIG on a row that
// saw no key).  p is rounded to bf16 while packing straight from the
// accumulator layout into the A fragments of acc += p @ v: two adjacent
// m16n8 score tiles are one m16k16 fragment, with no shared-memory round
// trip.  Each thread sums its own columns of l and the quad adds them at
// the end, in a fixed order, so the results are bit-for-bit repeatable.
// Under causal masking the heaviest q tiles go first (q tile gridDim.y - 1
// - blockIdx.y), and in a 128-row tile the m-tiles of the upper half skip
// the kv tiles that are dead for it.  Shared memory at D = 32: 5 (64
// rows) or 6 (128 rows) tiles of 64 x 40 bf16.  Registers and spills:
// chip_smoke.py's ptxas report ("fwd bf16 D=32 rows=128" and so on).
//
// float32 inputs: the FMA tile loop (flash_fwd_kernel, flash_partial_kernel;
// register-tiled 4 x 4 scores and 4 x D/16 accumulators a thread, tiles
// widened in shared memory, the scores through a shared-memory tile).  The
// float32 paths are the parity checks, held at 1e-5 of the plain version;
// TF32 tensor cores keep ~3 decimal digits and would not meet that.  The
// dispatch is by dtype, not a fallback: a bf16 tensor always reaches the
// tensor cores.
//
// Hopper's own route: bf16 calls at head sizes 64 and 128 run
// csrc/flash_fwd_wgmma.cu (wgmma fed by TMA: a producer warp
// fills a ring of K/V tiles under mbarriers, a consumer warpgroup of 64 q
// rows computes s = q k^T from shared memory and acc += p v with p from
// registers and V as an MN-major B; ops/flash.py fwd_route).  This file's
// bf16 kernels take head sizes 16 and 32.
#include <math_constants.h>

#include "flash_tiles.cuh"

namespace {

// ---------------------------------------------------------------- float32

constexpr int kThreads = 256;  // a 16 x 16 grid of threads

// The tile loop of one (batch * q head, q tile) block and its epilogue:
// kPartial selects the ring step's (acc, m, l) over (o, lse).
template <int D, bool kPartial>
__device__ __forceinline__ void flash_tiles(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o_out,
    float* __restrict__ row_a, float* __restrict__ row_b, int hq, int hkv,
    int s_len, int kv_len, int causal, int window, float sm_scale,
    int q_off, int kv_off) {
  constexpr int DP = D + 1;
  constexpr int SP = kBK + 1;
  constexpr int NJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [kBQ][D]
  float* k_s = q_s + kBQ * D;     // [kBK][D + 1]
  float* v_s = k_s + kBK * DP;    // [kBK][D]
  float* s_s = v_s + kBK * D;     // [kBQ][kBK + 1]
  float* m_s = s_s + kBQ * SP;    // [kBQ]
  float* l_s = m_s + kBQ;         // [kBQ]
  float* c_s = l_s + kBQ;         // [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const float* qb = q + static_cast<size_t>(bh) * s_len * D;
  const float* kb = k + static_cast<size_t>(kvh) * kv_len * D;
  const float* vb = v + static_cast<size_t>(kvh) * kv_len * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    q_s[i] = q0 + r < s_len ? qb[static_cast<size_t>(q0) * D + i] : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = SW_NEG_BIG;
    l_s[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_k = (kv_len + kBK - 1) / kBK;
  int k_first = 0, k_last = n_k - 1;
  if (causal) {
    // Local index of the last key the block's last row can see; negative
    // when every row precedes the kv shard (C's division truncates toward
    // zero, so that is tested first).
    const int hi = q_off + q0 + kBQ - 1 - kv_off;
    k_last = hi < 0 ? -1 : min(k_last, hi / kBK);
    if (window > 0)
      k_first = max(q_off + q0 - (window - 1) - kv_off, 0) / kBK;
  }
  __syncthreads();

  for (int kt = k_first; kt <= k_last; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D;
      const int c = i - j * D;
      float kv = 0.f, vv = 0.f;
      if (k0 + j < kv_len) {
        const size_t off = static_cast<size_t>(k0) * D + i;
        kv = kb[off];
        vv = vb[off];
      }
      k_s[j * DP + c] = kv;
      v_s[i] = vv;
    }
    __syncthreads();

    // Scores: rows ty + 16 i, keys tx + 16 j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * D + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = k_s[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q_off + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = kv_off + k0 + c;
        bool keep = k0 + c < kv_len;
        if (causal) {
          keep = keep && qp >= kp;
          if (window > 0) keep = keep && kp > qp - window;
        }
        s_s[r * SP + c] = keep ? sc[i][j] * sm_scale : SW_NEG_BIG;
      }
    }
    __syncthreads();

    // Online softmax: four threads per row, 16 keys each.
    {
      const int r = tid >> 2;
      const int sub = tid & 3;
      float mx = SW_NEG_BIG;
      for (int c = sub; c < kBK; c += 4) mx = fmaxf(mx, s_s[r * SP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      // A row whose window starts in a later tile is fully masked here:
      // clamping exp's argument keeps its p at exactly 0.
      const float m_use = fmaxf(m_new, SW_NEG_BIG / 2);
      float sum = 0.f;
      for (int c = sub; c < kBK; c += 4) {
        const float p = expf(s_s[r * SP + c] - m_use);
        sum += p;
        s_s[r * SP + c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (sub == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v: rows ty + 16 i, columns tx + 16 j.
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) corr[i] = c_s[ty + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr[i];
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* ob = o_out + static_cast<size_t>(bh) * s_len * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= s_len) continue;
    const size_t row = static_cast<size_t>(bh) * s_len + q0 + r;
    if constexpr (kPartial) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ob[static_cast<size_t>(q0 + r) * D + tx + 16 * j] = acc[i][j];
      if (tx == 0) {
        row_a[row] = m_s[r];
        row_b[row] = l_s[r];
      }
    } else {
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ob[static_cast<size_t>(q0 + r) * D + tx + 16 * j] = acc[i][j] / l;
      if (tx == 0) row_a[row] = m_s[r] + logf(l);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int hq, int hkv, int s_len,
                     int kv_len, int causal, int window, float sm_scale) {
  flash_tiles<D, false>(q, k, v, o, lse, nullptr, hq, hkv, s_len, kv_len,
                        causal, window, sm_scale, 0, 0);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_partial_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ acc,
    float* __restrict__ m, float* __restrict__ l, int hq, int hkv, int s_len,
    int kv_len, int causal, int window, float sm_scale, int q_off,
    int kv_off) {
  flash_tiles<D, true>(q, k, v, acc, m, l, hq, hkv, s_len, kv_len, causal,
                       window, sm_scale, q_off, kv_off);
}

// ------------------------------------------------------ bfloat16, mma.sync

// The tensor-core tile loop of one (batch * q head, q tile) block and its
// epilogue: kPartial selects the ring step's (acc, m, l) over (o, lse).
// 4 warps, each with MT m-tiles of 16 q rows: a q tile of MT sub-tiles of
// kBQ rows, m-tile m of warp w holding rows 16 w .. 16 w + 15 of sub-tile
// m.  The sub-tiles' live kv ranges are contiguous and overlap or touch:
// the block walks their union, and an m-tile skips the tiles that are dead
// for its sub-tile (all warps alike).  Grid (B * Hq, q tiles).
template <int D, int MT, bool kPartial>
__device__ __forceinline__ void flash_tiles_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, void* __restrict__ o_out,
    float* __restrict__ row_a, float* __restrict__ row_b, int hq, int hkv,
    int s_len, int kv_len, int causal, int window, float sm_scale,
    int q_off, int kv_off) {
  constexpr int LD = D + kPad;
  constexpr int TILE = kBQ * LD;
  constexpr int KD = D / 16;   // k-steps of s = q k^T over D
  constexpr int NT = D / 8;    // n-tiles of the accumulator over D
  constexpr int NS = kBK / 8;  // n-tiles of the score tile over the keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [MT][kBQ][LD]
  bf16* k_s = q_s + MT * TILE;                    // [2][kBK][LD]
  bf16* v_s = k_s + 2 * TILE;                     // [2][kBK][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t4 = lane & 3;  // accumulator columns 2 t4, 2 t4 + 1
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MT * kBQ;
  const int q_glob = q_off + q0;
  const int b = bh / hq;
  const int kvh = b * hkv + (bh - b * hq) / (hq / hkv);
  const bf16* kb = k + static_cast<size_t>(kvh) * kv_len * D;
  const bf16* vb = v + static_cast<size_t>(kvh) * kv_len * D;
  const int n_k = (kv_len + kBK - 1) / kBK;
  int lo = n_k, hi = -1;
  int sub_lo[MT], sub_hi[MT];  // sub-tile m's live kv tiles
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    live_range(n_k, kv_off, q_glob + m * kBQ, false, causal, window,
               &sub_lo[m], &sub_hi[m]);
    if (sub_lo[m] <= sub_hi[m]) {
      lo = min(lo, sub_lo[m]);
      hi = max(hi, sub_hi[m]);
    }
  }
  const int n_items = hi < lo ? 0 : hi - lo + 1;

  auto prefetch = [&](int item, int stage) {
    const int k0 = (lo + item) * kBK;
    load_tile_async<D>(k_s + stage * TILE, kb, k0, kv_len);
    load_tile_async<D>(v_s + stage * TILE, vb, k0, kv_len);
  };
  // This lane's ldmatrix row addresses: the A operand (q rows of the
  // warp), B stored [n][k] (K in s = q k^T) and B stored [k][n] (.trans:
  // V in p @ v).
  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int bn_row = (lane & 7) + ((lane >> 4) << 3);
  const int bn_col = ((lane >> 3) & 1) * 8;
  const int bt_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bt_col = (lane >> 4) * 8;

  // One m-tile's q rows stay in registers as the A fragments over D; with
  // two, they are read from shared memory at each k-step.
  uint32_t qa[MT == 1 ? KD : 1][4];
  if (n_items > 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      load_tile_async<D>(q_s + m * TILE,
                         q + static_cast<size_t>(bh) * s_len * D,
                         q0 + m * kBQ, s_len);
    cp_async_commit();
    prefetch(0, 0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (MT == 1) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qa[kk], smem_u32(q_s + a_row * LD + kk * 16 + a_col));
    }
  }

  float acc[MT][NT][4];  // m-tile m: q rows m kBQ + 16 warp + g (+ 8)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  // Rows g and g + 8 of each m-tile: the running max of s * sm_scale
  // (natural units) and this thread's part of the row sum.
  float m_row[MT][2], l_row[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_row[m][h] = SW_NEG_BIG;
      l_row[m][h] = 0.f;
    }
  const float scale_l2 = sm_scale * kLog2e;

  for (int it = 0; it < n_items; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_items) {
      prefetch(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kt = lo + it;
    const int k0 = kt * kBK;
    const int k_glob = kv_off + k0;
    const bf16* ks = k_s + stage * TILE;
    const bf16* vs = v_s + stage * TILE;
    bool live[MT];
    uint32_t pa[MT][kBK / 16][4];  // p in bf16: the A fragments of p @ v
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // One sub-tile's range is the block's: always live.
      live[m] = MT == 1 || (sub_lo[m] <= kt && kt <= sub_hi[m]);
      if (!live[m]) continue;
      const int r0 = m * kBQ + warp * 16;  // the m-tile's rows, from q0
      float s[NS][4];  // [key n-tile][fragment]: raw q . k
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        if constexpr (MT == 1) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = qa[kk][r];
        } else {
          ldsm_x4(a, smem_u32(q_s + (r0 + (lane & 15)) * LD + kk * 16 +
                              a_col));
        }
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bk[4];
          ldsm_x4(bk, smem_u32(ks + (jp * 16 + bn_row) * LD + kk * 16 +
                               bn_col));
          mma(s[2 * jp], a, bk[0], bk[1]);
          mma(s[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
      const int qm = q0 + m * kBQ;  // the m-tile's sub-tile
      if (tile_edge(qm, s_len, q_off + qm, k0, kv_len, k_glob, causal,
                    window)) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = j * 8 + 2 * t4 + (e & 1);
            const int ql = r0 + g + (e >> 1) * 8;
            if (!(q0 + ql < s_len && k0 + kl < kv_len &&
                  visible(q_glob + ql, k_glob + kl, causal, window)))
              s[j][e] = -CUDART_INF_F;
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
        // max(s) * scale is max(s * scale): rounding is monotone.  A row
        // that sees no key yet keeps m = NEG_BIG.
        const float m_new = fmaxf(m_row[m][h], mx * sm_scale);
        // A row whose window starts in a later tile is fully masked here:
        // with the clamp its p stays exactly 0 (its scores are -inf).
        const float m_l2 = fmaxf(m_new, SW_NEG_BIG / 2) * kLog2e;
        corr[h] = exp2f((m_row[m][h] - m_new) * kLog2e);
        m_row[m][h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[j][e] = exp2f(fmaf(s[j][e], scale_l2, -m_l2));
            sum += s[j][e];
          }
        l_row[m][h] = l_row[m][h] * corr[h] + sum;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[m][j][0] *= corr[0];
        acc[m][j][1] *= corr[0];
        acc[m][j][2] *= corr[1];
        acc[m][j][3] *= corr[1];
      }
      // Score n-tiles 2 kq and 2 kq + 1 are k-step kq of p @ v.
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        pa[m][j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
        pa[m][j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
      }
    }
#pragma unroll
    for (int kq = 0; kq < kBK / 16; ++kq) {
      const int row = (kq * 16 + bt_row) * LD + bt_col;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_u32(vs + row + np * 16));
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (live[m]) {
            mma(acc[m][2 * np], pa[m][kq], bv[0], bv[1]);
            mma(acc[m][2 * np + 1], pa[m][kq], bv[2], bv[3]);
          }
      }
    }
    __syncthreads();  // this stage is free for the copy after next
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // The row sum over the quad, in a fixed order.
      float l = l_row[m][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int r = q0 + m * kBQ + warp * 16 + g + h * 8;
      if (r >= s_len) continue;
      const size_t row = static_cast<size_t>(bh) * s_len + r;
      if constexpr (kPartial) {
        float* ob = static_cast<float*>(o_out) + row * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          store2<float>(ob + j * 8, acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        if (t4 == 0) {
          row_a[row] = m_row[m][h];
          row_b[row] = l;
        }
      } else {
        bf16* ob = static_cast<bf16*>(o_out) + row * D + 2 * t4;
        l = fmaxf(l, 1e-30f);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          store2<bf16>(ob + j * 8, acc[m][j][2 * h] / l,
                       acc[m][j][2 * h + 1] / l);
        if (t4 == 0) row_a[row] = m_row[m][h] + logf(l);
      }
    }
}

template <int D, int MT>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int hq, int hkv, int s_len, int kv_len,
    int causal, int window, float sm_scale) {
  flash_tiles_mma<D, MT, false>(q, k, v, o, lse, nullptr, hq, hkv, s_len,
                                kv_len, causal, window, sm_scale, 0, 0);
}

template <int D, int MT>
__global__ void __launch_bounds__(kMmaThreads) flash_partial_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, float* __restrict__ acc,
    float* __restrict__ m, float* __restrict__ l, int hq, int hkv, int s_len,
    int kv_len, int causal, int window, float sm_scale, int q_off,
    int kv_off) {
  flash_tiles_mma<D, MT, true>(q, k, v, acc, m, l, hq, hkv, s_len, kv_len,
                               causal, window, sm_scale, q_off, kv_off);
}

// ---------------------------------------------------------------- launch

struct FwdArgs {
  const void *q, *k, *v;
  void* o;                // o (T) or the partial's acc (float32)
  float *row_a, *row_b;   // lse, or the partial's m and l
  int b, hq, hkv, s_len, kv_len, causal, window, q_off, kv_off;
  float sm_scale;
  int q_rows;             // bf16: q rows a block, 64 or 128
  cudaStream_t stream;
};

template <int D, int MT, bool kPartial>
void launch_mma(const FwdArgs& a) {
  const dim3 grid(a.b * a.hq, (a.s_len + MT * kBQ - 1) / (MT * kBQ));
  const size_t smem = sizeof(bf16) * (MT + 4) * kBQ * (D + kPad);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  if constexpr (kPartial) {
    auto kernel = flash_partial_mma_kernel<D, MT>;
    sw_allow_smem(kernel, smem);
    kernel<<<grid, kMmaThreads, smem, a.stream>>>(
        q, k, v, static_cast<float*>(a.o), a.row_a, a.row_b, a.hq, a.hkv,
        a.s_len, a.kv_len, a.causal, a.window, a.sm_scale, a.q_off,
        a.kv_off);
  } else {
    auto kernel = flash_fwd_mma_kernel<D, MT>;
    sw_allow_smem(kernel, smem);
    kernel<<<grid, kMmaThreads, smem, a.stream>>>(
        q, k, v, static_cast<bf16*>(a.o), a.row_a, a.hq, a.hkv, a.s_len,
        a.kv_len, a.causal, a.window, a.sm_scale);
  }
}

template <int D, bool kPartial>
void launch_fma(const FwdArgs& a) {
  const dim3 grid((a.s_len + kBQ - 1) / kBQ, a.b * a.hq);
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D +
                                       kBQ * (kBK + 1) + 3 * kBQ);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  if constexpr (kPartial) {
    auto kernel = flash_partial_kernel<D>;
    sw_allow_smem(kernel, smem);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, static_cast<float*>(a.o), a.row_a, a.row_b, a.hq, a.hkv,
        a.s_len, a.kv_len, a.causal, a.window, a.sm_scale, a.q_off,
        a.kv_off);
  } else {
    auto kernel = flash_fwd_kernel<D>;
    sw_allow_smem(kernel, smem);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, static_cast<float*>(a.o), a.row_a, a.hq, a.hkv, a.s_len,
        a.kv_len, a.causal, a.window, a.sm_scale);
  }
}

// bf16 inputs reach the tensor-core kernels at the q-tile height the
// caller planned (ops/flash.py fwd_q_rows), float32 inputs the FMA loop.
// bf16 at D 64 and 128 is csrc/flash_fwd_wgmma.cu's; 128-row tiles exist
// for D = 32 (at D = 16 ptxas spills them).
template <int D, bool kPartial>
int launch(const FwdArgs& a, int is_bf16) {
  if (!is_bf16) {
    launch_fma<D, kPartial>(a);
  } else if constexpr (D > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (a.q_rows == kBQ) {
    launch_mma<D, 1, kPartial>(a);
  } else if constexpr (D == 32) {
    if (a.q_rows != 2 * kBQ) return static_cast<int>(cudaErrorInvalidValue);
    launch_mma<D, 2, kPartial>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kPartial>
int run(const FwdArgs& a, int d, int is_bf16) {
  switch (d) {
    case 16:
      return launch<16, kPartial>(a, is_bf16);
    case 32:
      return launch<32, kPartial>(a, is_bf16);
    case 64:
      return launch<64, kPartial>(a, is_bf16);
    case 128:
      return launch<128, kPartial>(a, is_bf16);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Hq, S, D], k/v [B, Hkv, Skv, D], o like q, lse [B, Hq, S] float32.
// D in {16, 32, 64, 128} for float32, {16, 32} for bf16; window 0 for none;
// q_rows the q-tile height of the bf16 kernels (64, or 128 at D = 32).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported D or q_rows).
extern "C" int sw_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int b, int hq, int hkv,
                            int s_len, int kv_len, int d, int causal,
                            int window, float sm_scale, int is_bf16,
                            int q_rows, void* stream) {
  const FwdArgs a{q, k, v, o, static_cast<float*>(lse), nullptr, b, hq, hkv,
                  s_len, kv_len, causal, window, 0, 0, sm_scale, q_rows,
                  static_cast<cudaStream_t>(stream)};
  return run<false>(a, d, is_bf16);
}

// One ring step: q [B, Hq, S, D] at global position q_off against k/v
// [B, Hkv, Skv, D] at kv_off; writes acc [B, Hq, S, D], m and l [B, Hq, S],
// all float32.  Otherwise as sw_flash_fwd.
extern "C" int sw_flash_partial(const void* q, const void* k, const void* v,
                                void* acc, void* m, void* l, int b, int hq,
                                int hkv, int s_len, int kv_len, int d,
                                int causal, int window, int q_off,
                                int kv_off, float sm_scale, int is_bf16,
                                int q_rows, void* stream) {
  const FwdArgs a{q, k, v, acc, static_cast<float*>(m),
                  static_cast<float*>(l), b, hq, hkv, s_len, kv_len, causal,
                  window, q_off, kv_off, sm_scale, q_rows,
                  static_cast<cudaStream_t>(stream)};
  return run<true>(a, d, is_bf16);
}
