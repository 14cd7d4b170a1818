// GQA flash-attention backward: two passes, causal or not, ragged S and
// Skv, sliding window, global [q_offset, kv_offset] coordinates.
//
// Replaces the TPU kernels starway_tpu/ops/pallas_attention.py
// _bwd_dkv_kernel (pass A) and _bwd_dq_kernel (pass B), with _bwd_block's
// recompute (driven there by _run_bwd_passes / _bwd_impl), and the ring
// step's flash_partial_bwd, which runs the same two passes at ring offsets
// and writes float32.
//
// Both passes recompute, per [64 q x 64 k] tile,
//   s = q k^T * sm_scale (masked),  p = exp(s - lse),
//   dp = dO v^T,  ds = p * (dp - delta),
// from the forward's saved row log-sum-exp ``lse`` and
// ``delta = rowsum(dO * O)`` (computed outside, as the JAX package does).
// A masked entry gets p = 0, and a q row or key past the end of the arrays
// is masked too, so a row or key with no visible partner contributes
// exactly 0.  Rounding points are the TPU kernel's: p is rounded to dO's
// dtype before p^T dO, and ds to q's / k's dtype before each product with
// them; everything else is float32.
//
// Pass A (kv-stationary) holds one 64-key tile of K and V and walks the
// live (q head of its kv head, 64-row q tile) pairs, accumulating
//   dv += p^T dO,  dk += ds^T q
// in float32 registers, so dk/dv sum the grouped query heads with no
// atomics; it writes dk * sm_scale and dv in the output type TO.  When
// its grid (kv tiles x B * Hkv) is too small to fill the card, the walk
// over the n_rep query heads is split along gridDim.z (the split factor is
// ops/flash.py dkv_splits, a function of the shapes): split z writes its
// own float32 partial dk/dv at offset z * B * Hkv * Skv * D, and the
// wrapper sums the partials in a fixed order, so results stay
// deterministic.  Pass B (q-stationary) holds one 64-row q tile and dO
// and walks the live kv tiles, accumulating dq += ds k; it writes
// dq * sm_scale.  TO is the input dtype for plain attention and float32
// for a ring step, whose n contributions the ring sums in float32.
//
// Live tiles follow the TPU kernels' tests: with causal masking a tile is
// dead when every key lies after every query, and with a window also when
// every key has fallen out of every query's window; dead tiles are neither
// read nor computed.  The live tiles of a block form one contiguous range.
// Element masks are applied only on tiles that cross the diagonal, the
// band edge or the end of the arrays.
//
// What bounds it: operations.  The function (dq, dk, dv) needs 5 products
// of 2 * D flops per visible (q, k) pair and q head (s, dp, dv, dk, dq)
// against O(S * D) bytes; the kernel does 7 by design, because both passes
// recompute s and dp (pass A 4 products, pass B 3), which buys dk/dv and
// dq with no atomics and no [S, S] matrix in device memory.
//
// bfloat16 inputs at head sizes 64 and 128: csrc/flash_bwd_wgmma.cu
// (Hopper's wgmma fed by TMA; ops/flash.py bwd_route).  bfloat16 inputs at
// 16 and 32: tensor cores (flash_bwd_dkv_mma_kernel,
// flash_bwd_dq_mma_kernel), in the style of FlashAttention-2.  128 threads,
// 4 warps; each warp owns 16 rows of the block's stationary tile (keys in
// pass A, q rows in pass B) and all D columns of its accumulators.  Every
// product is mma.sync.m16n8k16 bf16 -> f32 with operands from shared
// memory by ldmatrix (.trans for the operands stored [k][n]); pass A works
// in transposed space (s^T = K q^T, dp^T = V dO^T, K and V as the A
// operand) so that p^T and ds^T, rounded to bf16 while packing, are
// already the A fragments of dv += p^T dO and dk += ds^T q: two adjacent
// m16n8 accumulator tiles are one m16k16 A fragment, with no shared-memory
// round trip.  Pass B keeps ds in registers the same way for dq += ds k.
// The scores are formed 32 columns at a time.  Tiles are staged by 16-byte
// cp.async.cg (rows past the end zero-filled with a src-size of 0, never
// read), with rows padded to D + 8 bf16 so that ldmatrix's eight rows fall
// in distinct 16-byte bank groups; the stationary tiles are loaded once,
// and the walked tiles (plus the lse / delta rows in pass A) are double-
// buffered: the next live tile's copy is in flight while this one is
// computed.  Registers a thread (nvcc -Xptxas -v for sm_90a): pass A 128 at
// D = 32, 96 at 16, pass B 96 at both; no spills.  Blocks are ordered
// heaviest first under causal masking: pass A's low kv tiles and pass B's
// high q tiles walk the most tiles, and the tile index is the grid's y so
// that every head's heavy tiles go first.
//
// delta = rowsum(dO * O), which both passes read, is a kernel of its own
// here (flash_bwd_delta_kernel, every head size and both types): the JAX
// package computes it with one fused XLA pass (pallas_attention.py:560),
// and PyTorch's eager version, float32 copies of dO and O multiplied and
// summed, moves ten times the bytes it needs.  It is bound by bytes (dO
// and O read once, 16 bytes a thread); the D / 8 (bf16) or D / 4
// (float32) threads of a row add their sums in a fixed order.
//
// float32 inputs: the FMA tile loop (flash_bwd_dkv_kernel,
// flash_bwd_dq_kernel; register-tiled 4 x 4 scores and 4 x D/16
// accumulators a thread, tiles widened in shared memory).  The float32
// paths are the parity checks, held at 1e-4 to 1e-5 of the plain version;
// TF32 tensor cores keep ~3 decimal digits and would not meet that.  The
// dispatch is by dtype and head size, not a fallback: a bf16 tensor always
// reaches the tensor cores.
#include <type_traits>

#include "flash_tiles.cuh"  // tiles, liveness, staging (shared)

namespace {

// ---------------------------------------------------------------- float32

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kSP = kBK + 1;   // padded row of a [q][k] tile

// Tile [rows][D] of ``src`` (rows from ``r0``, ``n_rows`` valid) into
// shared memory with row stride D + 1; rows past the end read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n_rows) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * DP + c] =
        r0 + r < n_rows ? sw_to_float(src[static_cast<size_t>(r0) * D + i])
                        : 0.f;
  }
}

// The shared recompute (_bwd_block) of one tile: q rows ty + 16 i and keys
// tx + 16 j of this thread.  Writes p rounded to T into p_s (when given)
// and ds rounded to T into ds_s, both [kBQ][kSP].
template <typename T, int D>
__device__ __forceinline__ void bwd_block(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* dl_s, float* p_s, float* ds_s, int q0,
    int s_len, int q_glob, int k0, int kv_len, int k_glob, int causal,
    int window, float sm_scale) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
  for (int c = 0; c < D; ++c) {
    float a[4], g[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = q_s[(ty + 16 * i) * DP + c];
      g[i] = do_s[(ty + 16 * i) * DP + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = k_s[(tx + 16 * j) * DP + c];
      bv[j] = v_s[(tx + 16 * j) * DP + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
        dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool row_ok = q0 + r < s_len;
    const float lse = lse_s[r];
    const float delta = dl_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool keep = row_ok && k0 + c < kv_len &&
                        visible(q_glob + r, k_glob + c, causal, window);
      const float p = keep ? expf(sc[i][j] * sm_scale - lse) : 0.f;
      if (p_s != nullptr) p_s[r * kSP + c] = sw_round_to<T>(p);
      ds_s[r * kSP + c] = sw_round_to<T>(p * (dp[i][j] - delta));
    }
  }
}

// Row statistics of one q tile into shared memory (0 past the end).
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          const float* lse, const float* dl,
                                          int q0, int s_len) {
  if (threadIdx.x < kBQ) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < s_len ? lse[r] : 0.f;
    dl_s[threadIdx.x] = r < s_len ? dl[r] : 0.f;
  }
}

// Four [64][D + 1] tiles, ``n_sq`` [64][kSP] tiles and two rows.
template <int D>
constexpr size_t smem_bytes(int n_sq) {
  return sizeof(float) * (4 * kBQ * (D + 1) + n_sq * kBQ * kSP + 2 * kBQ);
}

// Pass A, float32: dK, dV.  Grid (kv tiles, B * Hkv, splits); split z
// walks query heads [z * n_rep / splits, (z + 1) * n_rep / splits) of its
// kv head and writes at offset z * B * Hkv * Skv * D.
template <typename T, typename TO, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dk, TO* __restrict__ dv,
    int hq, int hkv, int s_len, int kv_len, int causal, int window,
    float sm_scale, int q_off, int kv_off) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;               // [kBK][D + 1]
  float* v_s = k_s + kBK * DP;     // [kBK][D + 1]
  float* q_s = v_s + kBK * DP;     // [kBQ][D + 1]
  float* do_s = q_s + kBQ * DP;    // [kBQ][D + 1]
  float* p_s = do_s + kBQ * DP;    // [kBQ][kSP]
  float* ds_s = p_s + kBQ * kSP;   // [kBQ][kSP]
  float* lse_s = ds_s + kBQ * kSP;  // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBK;
  const int bkv = blockIdx.y;
  const int b = bkv / hkv;
  const int n_rep = hq / hkv;
  const int per = n_rep / gridDim.z;  // query heads of this split
  const int head0 =
      b * hq + (bkv - b * hkv) * n_rep + blockIdx.z * per;  // first q head
  const int k_glob = kv_off + k0;
  load_tile<T, D>(k_s, k + static_cast<size_t>(bkv) * kv_len * D, k0, kv_len);
  load_tile<T, D>(v_s, v + static_cast<size_t>(bkv) * kv_len * D, k0, kv_len);

  float acc_k[4][NJ], acc_v[4][NJ];  // key rows ty + 16 i, cols tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_q = (s_len + kBQ - 1) / kBQ;
  for (int rep = 0; rep < per; ++rep) {
    const size_t bh = head0 + rep;
    const T* qb = q + bh * s_len * D;
    const T* dob = dout + bh * s_len * D;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * kBQ;
      if (!tile_live(q_off + q0, k_glob, causal, window)) continue;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(q_s, qb, q0, s_len);
      load_tile<T, D>(do_s, dob, q0, s_len);
      load_rows(lse_s, dl_s, lse + bh * s_len, delta + bh * s_len, q0, s_len);
      __syncthreads();
      bwd_block<T, D>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, q0, s_len,
                      q_off + q0, k0, kv_len, k_glob, causal, window,
                      sm_scale);
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = p_s[r * kSP + ty + 16 * i];
          ds[i] = ds_s[r * kSP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float g = do_s[r * DP + tx + 16 * j];
          const float x = q_s[r * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][j] = fmaf(p[i], g, acc_v[i][j]);
            acc_k[i][j] = fmaf(ds[i], x, acc_k[i][j]);
          }
        }
      }
    }
  }

  const size_t base = (blockIdx.z * static_cast<size_t>(gridDim.y) + bkv) *
                      kv_len * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= kv_len) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t off = base + static_cast<size_t>(key) * D + tx + 16 * j;
      dk[off] = sw_from_float<TO>(acc_k[i][j] * sm_scale);
      dv[off] = sw_from_float<TO>(acc_v[i][j]);
    }
  }
}

// Pass B, float32: dQ.  Grid (q tiles, B * Hq).
template <typename T, typename TO, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dq, int hq, int hkv,
    int s_len, int kv_len, int causal, int window, float sm_scale, int q_off,
    int kv_off) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;               // [kBK][D + 1]
  float* v_s = k_s + kBK * DP;     // [kBK][D + 1]
  float* q_s = v_s + kBK * DP;     // [kBQ][D + 1]
  float* do_s = q_s + kBQ * DP;    // [kBQ][D + 1]
  float* ds_s = do_s + kBQ * DP;   // [kBQ][kSP]
  float* lse_s = ds_s + kBQ * kSP;  // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const int b = static_cast<int>(bh) / hq;
  const int kvh = b * hkv + (static_cast<int>(bh) - b * hq) / (hq / hkv);
  const T* kb = k + static_cast<size_t>(kvh) * kv_len * D;
  const T* vb = v + static_cast<size_t>(kvh) * kv_len * D;
  const int q_glob = q_off + q0;
  load_tile<T, D>(q_s, q + bh * s_len * D, q0, s_len);
  load_tile<T, D>(do_s, dout + bh * s_len * D, q0, s_len);
  load_rows(lse_s, dl_s, lse + bh * s_len, delta + bh * s_len, q0, s_len);

  float acc[4][NJ];  // q rows ty + 16 i, cols tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_k = (kv_len + kBK - 1) / kBK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBK;
    if (!tile_live(q_glob, kv_off + k0, causal, window)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, kb, k0, kv_len);
    load_tile<T, D>(v_s, vb, k0, kv_len);
    __syncthreads();
    bwd_block<T, D>(q_s, do_s, k_s, v_s, lse_s, dl_s, nullptr, ds_s, q0,
                    s_len, q_glob, k0, kv_len, kv_off + k0, causal, window,
                    sm_scale);
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = ds_s[(ty + 16 * i) * kSP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = k_s[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], x, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s_len) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dq[bh * s_len * D + static_cast<size_t>(r) * D + tx + 16 * j] =
          sw_from_float<TO>(acc[i][j] * sm_scale);
  }
}

// ------------------------------------------------------ bfloat16, mma.sync

// lse and delta of rows q0 .. q0 + 63 (0 past the end), 4 bytes a copy:
// a row of [B, Hq, S] float32 need not start on 16 bytes.
__device__ __forceinline__ void load_rows_async(float* lse_s, float* dl_s,
                                                const float* lse,
                                                const float* dl, int q0,
                                                int s_len) {
  static_assert(kMmaThreads == 2 * kBQ, "one row value a thread");
  const int r = threadIdx.x & (kBQ - 1);
  const bool ok = q0 + r < s_len;
  const float* src = threadIdx.x < kBQ ? lse : dl;
  float* dst = threadIdx.x < kBQ ? lse_s : dl_s;
  cp_async4(smem_u32(dst + r), ok ? src + q0 + r : src, ok ? 4 : 0);
}

// Shared memory of either pass: two stationary tiles, two double-buffered
// walked tiles and two stages of two 64-float rows.
template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * 6 * kBQ * (D + kPad) + sizeof(float) * 4 * kBQ;
}

// Pass A, bfloat16 on tensor cores: dK, dV.  Grid (B * Hkv, kv tiles,
// splits); kv tile blockIdx.y (low tiles walk the most q tiles under
// causal masking and go first); split z as in the float32 kernel.
template <typename TO, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    TO* __restrict__ dk, TO* __restrict__ dv, int hq, int hkv, int s_len,
    int kv_len, int causal, int window, float sm_scale, int q_off,
    int kv_off) {
  constexpr int LD = D + kPad;
  constexpr int TILE = kBQ * LD;
  constexpr int KD = D / 16;  // k-steps over D
  constexpr int NT = D / 8;   // n-tiles over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kBK][LD]
  bf16* v_s = k_s + TILE;                         // [kBK][LD]
  bf16* q_s = v_s + TILE;                         // [2][kBQ][LD]
  bf16* do_s = q_s + 2 * TILE;                    // [2][kBQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * TILE);  // [2][kBQ]
  float* dl_s = lse_s + 2 * kBQ;                             // [2][kBQ]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t4 = lane & 3;  // accumulator columns 2 t4, 2 t4 + 1
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int k_glob = kv_off + k0;
  const int b = bkv / hkv;
  const int n_rep = hq / hkv;
  const int per = n_rep / gridDim.z;
  const int head0 = b * hq + (bkv - b * hkv) * n_rep + blockIdx.z * per;
  int lo, hi;
  live_range((s_len + kBQ - 1) / kBQ, q_off, k_glob, true, causal, window,
             &lo, &hi);
  const int n_live = hi - lo + 1;
  const int n_items = hi < lo ? 0 : per * n_live;

  float acc_k[NT][4], acc_v[NT][4];  // key rows warp * 16 + g (+ 8)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  // Item i: query head head0 + i / n_live, q tile lo + i % n_live.
  auto prefetch = [&](int item, int stage) {
    const int rep = item / n_live;
    const int q0 = (lo + item - rep * n_live) * kBQ;
    const size_t bh = head0 + rep;
    load_tile_async<D>(q_s + stage * TILE, q + bh * s_len * D, q0, s_len);
    load_tile_async<D>(do_s + stage * TILE, dout + bh * s_len * D, q0, s_len);
    load_rows_async(lse_s + stage * kBQ, dl_s + stage * kBQ, lse + bh * s_len,
                    delta + bh * s_len, q0, s_len);
  };
  if (n_items > 0) {
    load_tile_async<D>(k_s, k + static_cast<size_t>(bkv) * kv_len * D, k0,
                       kv_len);
    load_tile_async<D>(v_s, v + static_cast<size_t>(bkv) * kv_len * D, k0,
                       kv_len);
    prefetch(0, 0);
    cp_async_commit();
  }
  const float scale_l2 = sm_scale * kLog2e;
  // This lane's ldmatrix row addresses: A operands (K, V rows of the
  // warp), B operands stored [n][k] (q, dO in s^T, dp^T) and stored
  // [k][n] (.trans: dO, q in dv, dk).
  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int bn_row = (lane & 7) + ((lane >> 4) << 3);
  const int bn_col = ((lane >> 3) & 1) * 8;
  const int bt_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bt_col = (lane >> 4) * 8;

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
    const int q0 = (lo + it % n_live) * kBQ;
    const bool edge = tile_edge(q0, s_len, q_off + q0, k0, kv_len, k_glob,
                                causal, window);
    const bf16* qs = q_s + stage * TILE;
    const bf16* dos = do_s + stage * TILE;
    const float* ls = lse_s + stage * kBQ;
    const float* dls = dl_s + stage * kBQ;
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {  // 32 queries at a time
      float s[4][4], dp[4][4];           // [q n-tile][fragment]
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, smem_u32(k_s + a_row * LD + kk * 16 + a_col));
        ldsm_x4(av, smem_u32(v_s + a_row * LD + kk * 16 + a_col));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int off = (sub * 32 + jp * 16 + bn_row) * LD + kk * 16 +
                          bn_col;
          uint32_t bq[4], bd[4];
          ldsm_x4(bq, smem_u32(qs + off));
          ldsm_x4(bd, smem_u32(dos + off));
          mma(s[2 * jp], ak, bq[0], bq[1]);
          mma(s[2 * jp + 1], ak, bq[2], bq[3]);
          mma(dp[2 * jp], av, bd[0], bd[1]);
          mma(dp[2 * jp + 1], av, bd[2], bd[3]);
        }
      }
      // p^T and ds^T, rounded to bf16 as the A fragments of the next
      // products: n-tiles 2 kq and 2 kq + 1 are k-step kq.
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = sub * 32 + j * 8 + 2 * t4 + (e & 1);
          const int kl = warp * 16 + g + (e >> 1) * 8;
          float pe = exp2f(s[j][e] * scale_l2 - ls[ql] * kLog2e);
          if (edge && !(q0 + ql < s_len && k0 + kl < kv_len &&
                        visible(q_off + q0 + ql, k_glob + kl, causal,
                                window)))
            pe = 0.f;
          p[e] = pe;
          ds[e] = pe * (dp[j][e] - dls[ql]);
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        da[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dv += p^T dO, dk += ds^T q over these 32 queries.
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        const int row = (sub * 32 + kq * 16 + bt_row) * LD + bt_col;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, smem_u32(dos + row + np * 16));
          ldsm_x4_t(bq, smem_u32(qs + row + np * 16));
          mma(acc_v[2 * np], pa[kq], bo[0], bo[1]);
          mma(acc_v[2 * np + 1], pa[kq], bo[2], bo[3]);
          mma(acc_k[2 * np], da[kq], bq[0], bq[1]);
          mma(acc_k[2 * np + 1], da[kq], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the copy after next
  }

  const size_t base =
      (blockIdx.z * static_cast<size_t>(gridDim.x) + bkv) * kv_len * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + h * 8;
    if (key >= kv_len) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const size_t off = base + static_cast<size_t>(key) * D + j * 8 + 2 * t4;
      store2<TO>(dk + off, acc_k[j][2 * h] * sm_scale,
                 acc_k[j][2 * h + 1] * sm_scale);
      store2<TO>(dv + off, acc_v[j][2 * h], acc_v[j][2 * h + 1]);
    }
  }
}

// Pass B, bfloat16 on tensor cores: dQ.  Grid (B * Hq, q tiles); q tile
// gridDim.y - 1 - blockIdx.y (high tiles walk the most kv tiles under
// causal masking and go first).
template <typename TO, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    TO* __restrict__ dq, int hq, int hkv, int s_len, int kv_len, int causal,
    int window, float sm_scale, int q_off, int kv_off) {
  constexpr int LD = D + kPad;
  constexpr int TILE = kBQ * LD;
  constexpr int KD = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  bf16* do_s = q_s + TILE;                        // [kBQ][LD]
  bf16* k_s = do_s + TILE;                        // [2][kBK][LD]
  bf16* v_s = k_s + 2 * TILE;                     // [2][kBK][LD]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * TILE);  // [kBQ]
  float* dl_s = lse_s + kBQ;                                // [kBQ]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_glob = q_off + q0;
  const int b = static_cast<int>(bh) / hq;
  const int kvh = b * hkv + (static_cast<int>(bh) - b * hq) / (hq / hkv);
  const bf16* kb = k + static_cast<size_t>(kvh) * kv_len * D;
  const bf16* vb = v + static_cast<size_t>(kvh) * kv_len * D;
  int lo, hi;
  live_range((kv_len + kBK - 1) / kBK, kv_off, q_glob, false, causal, window,
             &lo, &hi);
  const int n_items = hi < lo ? 0 : hi - lo + 1;

  float acc[NT][4];  // q rows warp * 16 + g (+ 8)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  auto prefetch = [&](int item, int stage) {
    const int k0 = (lo + item) * kBK;
    load_tile_async<D>(k_s + stage * TILE, kb, k0, kv_len);
    load_tile_async<D>(v_s + stage * TILE, vb, k0, kv_len);
  };
  if (n_items > 0) {
    load_tile_async<D>(q_s, q + bh * s_len * D, q0, s_len);
    load_tile_async<D>(do_s, dout + bh * s_len * D, q0, s_len);
    load_rows_async(lse_s, dl_s, lse + bh * s_len, delta + bh * s_len, q0,
                    s_len);
    prefetch(0, 0);
    cp_async_commit();
  }
  const float scale_l2 = sm_scale * kLog2e;
  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int bn_row = (lane & 7) + ((lane >> 4) << 3);
  const int bn_col = ((lane >> 3) & 1) * 8;
  const int bt_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bt_col = (lane >> 4) * 8;

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
    const int k0 = (lo + it) * kBK;
    const int k_glob = kv_off + k0;
    const bool edge = tile_edge(q0, s_len, q_glob, k0, kv_len, k_glob, causal,
                                window);
    const bf16* ks = k_s + stage * TILE;
    const bf16* vs = v_s + stage * TILE;
    float lse_l2[2], dl[2];  // rows warp * 16 + g and + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse_l2[h] = lse_s[warp * 16 + g + h * 8] * kLog2e;
      dl[h] = dl_s[warp * 16 + g + h * 8];
    }
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {  // 32 keys at a time
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[4], ad[4];
        ldsm_x4(aq, smem_u32(q_s + a_row * LD + kk * 16 + a_col));
        ldsm_x4(ad, smem_u32(do_s + a_row * LD + kk * 16 + a_col));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int off = (sub * 32 + jp * 16 + bn_row) * LD + kk * 16 +
                          bn_col;
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, smem_u32(ks + off));
          ldsm_x4(bv, smem_u32(vs + off));
          mma(s[2 * jp], aq, bk[0], bk[1]);
          mma(s[2 * jp + 1], aq, bk[2], bk[3]);
          mma(dp[2 * jp], ad, bv[0], bv[1]);
          mma(dp[2 * jp + 1], ad, bv[2], bv[3]);
        }
      }
      uint32_t da[2][4];  // ds rounded to bf16: the A fragments of ds k
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = sub * 32 + j * 8 + 2 * t4 + (e & 1);
          const int ql = warp * 16 + g + (e >> 1) * 8;
          float pe = exp2f(s[j][e] * scale_l2 - lse_l2[e >> 1]);
          if (edge && !(q0 + ql < s_len && k0 + kl < kv_len &&
                        visible(q_glob + ql, k_glob + kl, causal, window)))
            pe = 0.f;
          ds[e] = pe * (dp[j][e] - dl[e >> 1]);
        }
        da[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        const int row = (sub * 32 + kq * 16 + bt_row) * LD + bt_col;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4_t(bk, smem_u32(ks + row + np * 16));
          mma(acc[2 * np], da[kq], bk[0], bk[1]);
          mma(acc[2 * np + 1], da[kq], bk[2], bk[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + h * 8;
    if (r >= s_len) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store2<TO>(dq + bh * s_len * D + static_cast<size_t>(r) * D + j * 8 +
                     2 * t4,
                 acc[j][2 * h] * sm_scale, acc[j][2 * h + 1] * sm_scale);
  }
}

// ------------------------------------------------------------------ delta

// delta[r] = sum over d of dO[r, d] * O[r, d] in float32, rows of D values.
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(
    const T* __restrict__ dout, const T* __restrict__ o,
    float* __restrict__ delta, int rows) {
  constexpr int V = 16 / sizeof(T);  // values a thread
  constexpr int TR = D / V;          // threads a row: 2 .. 32
  const int row = blockIdx.x * (256 / TR) + threadIdx.x / TR;
  const int lane = threadIdx.x % TR;
  float sum = 0.f;
  if (row < rows) {
    const size_t at = static_cast<size_t>(row) * D + lane * V;
    const uint4 a = *reinterpret_cast<const uint4*>(dout + at);
    const uint4 b = *reinterpret_cast<const uint4*>(o + at);
    const T* x = reinterpret_cast<const T*>(&a);
    const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int i = 0; i < V; ++i)
      sum = fmaf(sw_to_float(x[i]), sw_to_float(y[i]), sum);
  }
#pragma unroll
  for (int off = TR / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && lane == 0) delta[row] = sum;
}

template <typename T>
int launch_delta(const void* dout, const void* o, void* delta, int rows,
                 int d, cudaStream_t stream) {
  const auto go = [&](auto kernel, int per_block) {
    kernel<<<(rows + per_block - 1) / per_block, 256, 0, stream>>>(
        static_cast<const T*>(dout), static_cast<const T*>(o),
        static_cast<float*>(delta), rows);
    return static_cast<int>(cudaGetLastError());
  };
  constexpr int V = 16 / sizeof(T);
  switch (d) {
    case 16: return go(flash_bwd_delta_kernel<T, 16>, 256 * V / 16);
    case 32: return go(flash_bwd_delta_kernel<T, 32>, 256 * V / 32);
    case 64: return go(flash_bwd_delta_kernel<T, 64>, 256 * V / 64);
    case 128: return go(flash_bwd_delta_kernel<T, 128>, 256 * V / 128);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int b, hq, hkv, s_len, kv_len, causal, window, q_off, kv_off;
  float sm_scale;
  int n_split;
  cudaStream_t stream;
};

int n_tiles(int n) { return (n + kBQ - 1) / kBQ; }

template <typename T, typename TO, int D>
int launch_dkv(const Args& a) {
  const dim3 grid_fma(n_tiles(a.kv_len), a.b * a.hkv, a.n_split);
  const dim3 grid_mma(a.b * a.hkv, n_tiles(a.kv_len), a.n_split);
  const auto launch = [&](auto kernel, dim3 grid, int threads, size_t smem) {
    sw_allow_smem(kernel, smem);
    kernel<<<grid, threads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<TO*>(a.dk), static_cast<TO*>(a.dv), a.hq, a.hkv, a.s_len,
        a.kv_len, a.causal, a.window, a.sm_scale, a.q_off, a.kv_off);
  };
  if constexpr (std::is_same_v<T, bf16>)
    launch(flash_bwd_dkv_mma_kernel<TO, D>, grid_mma, kMmaThreads,
         mma_smem_bytes<D>());
  else
    launch(flash_bwd_dkv_kernel<T, TO, D>, grid_fma, kThreads,
         smem_bytes<D>(2));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO, int D>
int launch_dq(const Args& a) {
  const auto launch = [&](auto kernel, dim3 grid, int threads, size_t smem) {
    sw_allow_smem(kernel, smem);
    kernel<<<grid, threads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<TO*>(a.dq), a.hq, a.hkv, a.s_len, a.kv_len, a.causal,
        a.window, a.sm_scale, a.q_off, a.kv_off);
  };
  if constexpr (std::is_same_v<T, bf16>)
    launch(flash_bwd_dq_mma_kernel<TO, D>, dim3(a.b * a.hq, n_tiles(a.s_len)),
         kMmaThreads, mma_smem_bytes<D>());
  else
    launch(flash_bwd_dq_kernel<T, TO, D>, dim3(n_tiles(a.s_len), a.b * a.hq),
         kThreads, smem_bytes<D>(1));
  return static_cast<int>(cudaGetLastError());
}

// bf16 at head sizes 16 and 32 (64 and 128 are csrc/flash_bwd_wgmma.cu's),
// float32 at every head size.
template <typename T, typename TO, bool kDkv>
int dispatch(const Args& a, int d) {
  switch (d) {
    case 16:
      return kDkv ? launch_dkv<T, TO, 16>(a) : launch_dq<T, TO, 16>(a);
    case 32:
      return kDkv ? launch_dkv<T, TO, 32>(a) : launch_dq<T, TO, 32>(a);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (d == 64)
      return kDkv ? launch_dkv<T, TO, 64>(a) : launch_dq<T, TO, 64>(a);
    if (d == 128)
      return kDkv ? launch_dkv<T, TO, 128>(a) : launch_dq<T, TO, 128>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Output type: the input's, or float32 when ``out_f32`` (a ring step, or
// the partials of a split pass A).  bf16 inputs reach the tensor-core
// kernels, float32 inputs the FMA loop.
template <bool kDkv>
int run(const Args& a, int d, int out_f32, int is_bf16) {
  if (!is_bf16) return dispatch<float, float, kDkv>(a, d);
  return out_f32 ? dispatch<bf16, float, kDkv>(a, d)
                 : dispatch<bf16, bf16, kDkv>(a, d);
}

}  // namespace

// Pass A, split ``n_split`` ways over each kv head's n_rep query heads.
// q/dout [B, Hq, S, D], k/v [B, Hkv, Skv, D], lse/delta [B, Hq, S]
// float32; writes dk/dv [n_split, B, Hkv, Skv, D]: split z holds the sum
// over query heads [z * n_rep / n_split, (z + 1) * n_rep / n_split) of
// each kv head.  n_split must divide n_rep, and above 1 the outputs must
// be float32 (out_f32).  D in {16, 32} for bf16, {16, 32, 64, 128} for
// float32; window 0 for none; q_off/kv_off are the global positions of
// row 0 of q and of k.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported D or split).
extern "C" int sw_flash_bwd_dkv_split(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int hq,
    int hkv, int s_len, int kv_len, int d, int causal, int window, int q_off,
    int kv_off, float sm_scale, int out_f32, int is_bf16, int n_split,
    void* stream) {
  if (n_split < 1 || (hq / hkv) % n_split || (n_split > 1 && !out_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, b, hq, hkv, s_len,
               kv_len, causal, window, q_off, kv_off, sm_scale, n_split,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, d, out_f32, is_bf16);
}

// Pass B.  Same inputs as pass A; writes dq [B, Hq, S, D] in the input
// dtype, or in float32 when out_f32.
extern "C" int sw_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int b, int hq,
                               int hkv, int s_len, int kv_len, int d,
                               int causal, int window, int q_off, int kv_off,
                               float sm_scale, int out_f32, int is_bf16,
                               void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, b, hq, hkv,
               s_len, kv_len, causal, window, q_off, kv_off, sm_scale, 1,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, d, out_f32, is_bf16);
}

// delta = rowsum(dO * O): dout and o [rows, D] bf16 (is_bf16) or float32,
// 16-byte aligned, D in {16, 32, 64, 128}; writes delta [rows] float32.
extern "C" int sw_flash_bwd_delta(const void* dout, const void* o,
                                  void* delta, int rows, int d, int is_bf16,
                                  void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_delta<bf16>(dout, o, delta, rows, d, st)
                 : launch_delta<float>(dout, o, delta, rows, d, st);
}
