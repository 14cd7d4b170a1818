// The bf16 flash-attention backward on Hopper's own tensor cores and
// copies: warpgroup matrix multiplies (wgmma) fed by TMA.  The same two
// passes as csrc/flash_bwd.cu (see its note for the function, the masks,
// the rounding points and the split of pass A over query heads), which
// keeps the head sizes this one does not take, 16 and 32 (mma.sync), and
// float32 (the FMA loop; ops/flash.py bwd_route).  q, k, v and dO are read
// by TMA, so their bases must be 16-byte aligned (the wrappers refuse
// others); lse and delta are read by plain loads, since their rows start
// anywhere when S is ragged.
//
// Replaces the TPU kernels starway_tpu/ops/pallas_attention.py
// _bwd_dkv_kernel (:309, pass A) and _bwd_dq_kernel (:364, pass B), driven
// there by _run_bwd_passes (:406) and _bwd_impl (:552), and the ring step's
// flash_partial_bwd (:734), which runs both passes at ring offsets with
// float32 outputs.
//
// What bounds it: operations.  Per visible (q, k) pair and q head the
// function needs 5 products of 2 D flops (s, dp, dv, dk, dq); the two
// passes do 7 (both recompute s and dp), which buys dq and dk/dv with no
// atomics: every sum is taken in a fixed order and the results are
// bit-for-bit repeatable.  (One pass with dq summed by atomics, as
// FlashAttention-3 does it, would need 5, but dq's bits would change from
// run to run.)  mma.sync, Ampere's instruction, runs on Hopper at well
// under its full rate, and its operands go shared memory -> registers by
// ldmatrix first; wgmma reads B, and here also A where it is a tile, from
// shared memory, and TMA moves a tile with one thread's instruction.  The
// design, csrc/flash_fwd_wgmma.cu's with the roles of the tiles swapped:
//
// * A block is 256 threads: a producer warpgroup, which gives up registers
//   (setmaxnreg.dec to 24) and of which one warp works, and one consumer
//   warpgroup, which takes them (to 232) and owns the block's 64
//   stationary rows (keys in pass A, q rows in pass B).  Two blocks share
//   an SM and fill each other's waits on the tensor cores (the forward
//   measured two 64-row blocks faster than one of 128 rows and two
//   consumers).
// * The stationary tiles are loaded once by TMA; the walked tiles come
//   through a two-stage ring of 64-row tiles (pass A: q and dO, and the
//   tile's lse and delta rows, which the producer warp's lanes copy with
//   plain loads while the tiles' TMA is in flight; pass B: K and V) under
//   mbarriers, each tile D / 64 boxes of 64 rows x 128 bytes, 128-byte
//   swizzled (3D tensor maps over [B * H, S, D]: rows past S or Skv arrive
//   as zeros, and no tile crosses into the next head).  A stage is
//   refilled once every consumer warp has arrived on its "empty" barrier.
//   (A third stage would cost the second block of an SM; the copies are
//   not what bounds either pass: with the walked tiles never reloaded,
//   pass A ran no faster.)
// * Pass A (dK/dV, kv-stationary) works in transposed space:
//   s^T = K q^T and dp^T = V dO^T are wgmma.m64n64k16 with K / V as A and
//   q / dO as B, all K-major from shared memory; p^T and ds^T, rounded to
//   bf16 in registers, are the A fragments of dv += p^T dO and
//   dk += ds^T q (the accumulator's layout is mma.sync's m16n8 tiles side
//   by side: two adjacent tiles are one m16k16 fragment), with dO and q
//   as an MN-major B (the transpose bit; atoms of 8 rows x 64 columns,
//   1024 bytes apart along the rows, 8192 along D).  Registers bound this
//   pass: dk and dv hold 2 x D / 2 floats a thread, s^T and dp^T 64, so a
//   step waits for both scores, builds p^T and ds^T 16 columns at a time
//   (each score's registers free once packed) and issues both products;
//   building p^T while dp^T runs kept p^T, dp^T and both fragments live at
//   once, and ptxas then serialized every wgmma of the loop (C7512) at
//   D = 128, as it did when the next step's scores were issued beside the
//   dk product.
// * Pass B (dQ, q-stationary): s = q K^T and dp = dO V^T, K-major; ds in
//   registers for dq += ds K with K as an MN-major B.  Step it's s and dp
//   are issued beside step it - 1's dq product, and p is built while dp
//   finishes.  (q and dO as register A fragments, read once, ran slower.)
// * The rows' statistics and masks are the mma.sync kernels': p =
//   exp2(s * scale * log2 e - lse * log2 e), live_range skips dead tiles
//   (neither read nor computed), element masks apply only on the tiles
//   that tile_edge says cross the diagonal, the band edge or an array
//   end, and under causal masking the heaviest blocks go first (pass A's
//   low kv tiles, pass B's high q tiles).  Each product sums its k16 steps
//   in the mma.sync kernels' order.
// * The split of pass A over query heads (ops/flash.py dkv_splits) is
//   planned as for the mma.sync kernel: its blocks are still 64 keys, two
//   an SM, so the grid needs 2 x the SM count blocks either way.
// * What is left (PERF.md §6): each pass runs at about 0.4 of the card's
//   bf16 rate.  Its steps are chains (scores, then the exponentials, then
//   the products that read them) that only two consumer warpgroups an SM
//   overlap, and pass A's registers leave no room to run a step's scores
//   beside the previous step's products.
//
// Shared memory at D = 128: two stationary tiles and two stages of two
// walked tiles, 16 KB each, and the rows: 98 KB, two blocks an SM.
// Registers: PERF.md's kernel table (ptxas -v for sm_90a, chip_smoke.py's
// report, "dkv wgmma" and "dq wgmma").
#include <math_constants.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kStages = 2;      // the walked ring
constexpr int kBox = 64 * 128;  // bytes of a 64-row, 128-byte box

template <int D>
struct BwdLayout {
  static constexpr int kTile = 64 * D * 2;  // a [64][D] bf16 tile
  // Two stationary tiles, then the ring: kStages x two walked tiles.
  static constexpr int kTiles = 2 + 2 * kStages;
  // Pass A's lse and delta rows of each stage, then the mbarriers:
  // the stationary tiles' "full", and each stage's "full" and "empty".
  static constexpr int kRowBytes = kStages * 2 * kBQ * 4;
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kTiles) * kTile + kRowBytes + 8 * kBars;
};

// The block's shared memory and barriers.
template <int D>
struct Smem {
  uint32_t stat;   // the two stationary tiles, kTile apart
  uint32_t ring;   // stage s: two walked tiles at ring + 2 s kTile
  float* rows;     // stage s: lse at rows + 2 s kBQ, delta kBQ on
  uint32_t bar;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    using L = BwdLayout<D>;
    unsigned char* sm = align_1024(raw);
    stat = smem_u32(sm);
    ring = stat + 2 * L::kTile;
    rows = reinterpret_cast<float*>(sm + L::kTiles * L::kTile);
    bar = smem_u32(rows) + L::kRowBytes;
  }
  __device__ __forceinline__ uint32_t stat_full() const { return bar; }
  __device__ __forceinline__ uint32_t full(int s) const {
    return bar + 8 * (1 + s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bar + 8 * (1 + kStages + s);
  }
  __device__ __forceinline__ uint32_t walked(int s, int i) const {
    return ring + (2 * s + i) * BwdLayout<D>::kTile;
  }
  // ``full`` waits for ``full_count`` arrivals a phase, ``empty`` for the
  // four consumer warps.
  __device__ __forceinline__ void init(int full_count) const {
    mbar_init(stat_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), full_count);
      mbar_init(empty(s), 4);
    }
    mbar_fence_init();
  }
};

__device__ __forceinline__ int stage_of(int it) { return it % kStages; }
__device__ __forceinline__ uint32_t parity_of(int it) {
  return static_cast<uint32_t>(it / kStages) & 1;
}

// One [64][D] tile at rows r0 of head ``head`` of ``map`` into ``dst``.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int head) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    tma_load_3d(dst + cb * kBox, map, bar, cb * 64, r0, head);
}

// d[64 x 64] = a b^T over D: a and b [64][D] tiles in shared memory, both
// K-major (D / 16 steps of 32 bytes along a box, then the next box); one
// wgmma group, issued.
template <int D>
__device__ __forceinline__ void tile_product(float (&d)[32], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
    wgmma_ss_n64(d, gmma_desc(a + off, 16, 1024),
                 gmma_desc(b + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// acc[64 x D] += a[64 x 64] t: a from registers (k-step kq in a[kq]), t a
// [64][D] tile in shared memory as an MN-major B; one wgmma group, issued.
template <int D>
__device__ __forceinline__ void acc_product(float (&acc)[D / 2],
                                            const uint32_t (&a)[4][4],
                                            uint32_t t) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    const uint64_t db = gmma_desc(t + kq * 2048, kBox, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128<1>(acc, a[kq], db, 1);
    else
      wgmma_rs_n64<1>(acc, a[kq], db, 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Pass A: dK, dV.  Grid (B * Hkv, kv tiles, splits); kv tile blockIdx.y
// (low tiles walk the most q tiles under causal masking and go first);
// split z walks query heads [z * n_rep / splits, (z + 1) * n_rep / splits)
// of its kv head and writes at offset z * B * Hkv * Skv * D.
template <int D, typename TO>
__global__ void __launch_bounds__(256, 2) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dk,
    TO* __restrict__ dv, int hq, int hkv, int s_len, int kv_len, int causal,
    int window, float sm_scale, int q_off, int kv_off) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const uint32_t k_s = sm.stat;
  const uint32_t v_s = sm.stat + BwdLayout<D>::kTile;

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int k_glob = kv_off + k0;
  const int b = bkv / hkv;
  const int n_rep = hq / hkv;
  const int per = n_rep / gridDim.z;
  const int head0 = b * hq + (bkv - b * hkv) * n_rep + blockIdx.z * per;
  int lo, hi;  // the live q tiles
  live_range((s_len + kBQ - 1) / kBQ, q_off, k_glob, true, causal, window,
             &lo, &hi);
  const int n_live = hi - lo + 1;
  const int n_items = hi < lo ? 0 : per * n_live;

  if (threadIdx.x == 0) sm.init(32);  // the producer warp's lanes
  __syncthreads();

  // Item it: query head head0 + it / n_live, q tile lo + it % n_live.
  if (threadIdx.x < 128) {  // ---------------------------------- producer
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x;
    if (lane < 32 && n_items > 0) {
      if (lane == 0) {
        mbar_expect_tx(sm.stat_full(), 2 * BwdLayout<D>::kTile);
        load_tile<D>(k_s, &k_map, sm.stat_full(), k0, bkv);
        load_tile<D>(v_s, &v_map, sm.stat_full(), k0, bkv);
      }
      for (int it = 0; it < n_items; ++it) {
        const int s = stage_of(it);
        if (it >= kStages) mbar_wait(sm.empty(s), parity_of(it) ^ 1);
        const int rep = it / n_live;
        const int q0 = (lo + it - rep * n_live) * kBQ;
        const int bh = head0 + rep;
        if (lane == 0) {  // the tiles first: their copy hides the rows'
          mbar_expect_bytes(sm.full(s), 2 * BwdLayout<D>::kTile);
          load_tile<D>(sm.walked(s, 0), &q_map, sm.full(s), q0, bh);
          load_tile<D>(sm.walked(s, 1), &do_map, sm.full(s), q0, bh);
        }
        float* ls = sm.rows + 2 * s * kBQ;
        const size_t row0 = static_cast<size_t>(bh) * s_len + q0;
        for (int i = lane; i < kBQ; i += 32) {
          const bool ok = q0 + i < s_len;
          ls[i] = ok ? lse[row0 + i] : 0.f;
          ls[kBQ + i] = ok ? delta[row0 + i] : 0.f;
        }
        mbar_arrive(sm.full(s));
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumer
  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = 16 * warp;  // the warp's keys of the tile

  float acc_k[D / 2], acc_v[D / 2];  // [D / 8 n8 tiles][4]: keys r0 + g (+ 8)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const float scale_l2 = sm_scale * kLog2e;
  if (n_items > 0) mbar_wait(sm.stat_full(), 0);

  // The loop is straight-line code around the wgmmas: wgmmas in
  // data-dependent branches make ptxas serialize them.
  for (int it = 0; it < n_items; ++it) {
    const int s = stage_of(it);
    const int rep = it / n_live;
    const int q0 = (lo + it - rep * n_live) * kBQ;
    const uint32_t q_s = sm.walked(s, 0);
    const uint32_t do_s = sm.walked(s, 1);
    const float* ls = sm.rows + 2 * s * kBQ;
    float sc[32], dp[32];  // [8 q n8 tiles][4]: s^T, dp^T
    uint32_t pa[4][4], da[4][4];  // p^T, ds^T: bf16 fragments
    mbar_wait(sm.full(s), parity_of(it));
    wgmma_fence();
    tile_product<D>(sc, k_s, q_s);
    tile_product<D>(dp, v_s, do_s);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const bool edge = tile_edge(q0, s_len, q_off + q0, k0, kv_len, k_glob,
                                causal, window);
    // p^T and ds^T, 16 q columns (one k-step of the products) at a time,
    // so that each score's registers are free once packed.
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      float p[8], ds[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kq + h;
        const int qc = 8 * j + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(ls + kBQ + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qc + (e & 1);
          const int kl = r0 + g + (e >> 1) * 8;
          float pe = exp2f(sc[4 * j + e] * scale_l2 -
                           ((e & 1) ? l2.y : l2.x) * kLog2e);
          if (edge && !(q0 + ql < s_len && k0 + kl < kv_len &&
                        visible(q_off + q0 + ql, k_glob + kl, causal,
                                window)))
            pe = 0.f;
          p[4 * h + e] = pe;
          ds[4 * h + e] = pe * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kq][r] = pack_bf16(p[2 * r], p[2 * r + 1]);
        da[kq][r] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
      }
    }
    wgmma_fence();
    acc_product<D>(acc_v, pa, do_s);  // dv += p^T dO
    acc_product<D>(acc_k, da, q_s);   // dk += ds^T q
    wgmma_wait<0>();
    fence_regs(acc_k);
    fence_regs(acc_v);
    release(sm.empty(s), lane);
  }

  const size_t base =
      (blockIdx.z * static_cast<size_t>(gridDim.x) + bkv) * kv_len * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r0 + g + h * 8;
    if (key >= kv_len) continue;
    const size_t row = base + static_cast<size_t>(key) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2<TO>(dk + row + j * 8, acc_k[4 * j + 2 * h] * sm_scale,
                 acc_k[4 * j + 2 * h + 1] * sm_scale);
      store2<TO>(dv + row + j * 8, acc_v[4 * j + 2 * h],
                 acc_v[4 * j + 2 * h + 1]);
    }
  }
}

// Pass B: dQ.  Grid (B * Hq, q tiles); q tile gridDim.y - 1 - blockIdx.y
// (high tiles walk the most kv tiles under causal masking and go first).
template <int D, typename TO>
__global__ void __launch_bounds__(256, 2) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dq, int hq, int hkv,
    int s_len, int kv_len, int causal, int window, float sm_scale, int q_off,
    int kv_off) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const uint32_t q_s = sm.stat;
  const uint32_t do_s = sm.stat + BwdLayout<D>::kTile;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_glob = q_off + q0;
  const int b = bh / hq;
  const int kvh = b * hkv + (bh - b * hq) / (hq / hkv);
  int lo, hi;  // the live kv tiles
  live_range((kv_len + kBK - 1) / kBK, kv_off, q_glob, false, causal, window,
             &lo, &hi);
  const int n_items = hi < lo ? 0 : hi - lo + 1;

  if (threadIdx.x == 0) sm.init(1);
  __syncthreads();

  if (threadIdx.x < 128) {  // ---------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_items > 0) {
      mbar_expect_tx(sm.stat_full(), 2 * BwdLayout<D>::kTile);
      load_tile<D>(q_s, &q_map, sm.stat_full(), q0, bh);
      load_tile<D>(do_s, &do_map, sm.stat_full(), q0, bh);
      for (int it = 0; it < n_items; ++it) {
        const int s = stage_of(it);
        const int k0 = (lo + it) * kBK;
        if (it >= kStages) mbar_wait(sm.empty(s), parity_of(it) ^ 1);
        mbar_expect_tx(sm.full(s), 2 * BwdLayout<D>::kTile);
        load_tile<D>(sm.walked(s, 0), &k_map, sm.full(s), k0, kvh);
        load_tile<D>(sm.walked(s, 1), &v_map, sm.full(s), k0, kvh);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumer
  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = 16 * warp;  // the warp's q rows of the tile

  float lse_l2[2], dl[2];  // rows r0 + g (h = 0) and r0 + g + 8 (h = 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + g + h * 8;
    const size_t at = static_cast<size_t>(bh) * s_len + r;
    lse_l2[h] = r < s_len ? lse[at] * kLog2e : 0.f;
    dl[h] = r < s_len ? delta[at] : 0.f;
  }
  float acc[D / 2];  // [D / 8 n8 tiles][4]: q rows r0 + g (+ 8)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float scale_l2 = sm_scale * kLog2e;
  if (n_items > 0) mbar_wait(sm.stat_full(), 0);

  float sc[32], dp[32];  // [8 key n8 tiles][4]: s, then p; dp, then ds
  uint32_t da[4][4];
  for (int it = 0; it < n_items; ++it) {
    const int s = stage_of(it);
    const uint32_t k_s = sm.walked(s, 0);
    const uint32_t v_s = sm.walked(s, 1);
    const int k0 = (lo + it) * kBK;
    const int k_glob = kv_off + k0;
    mbar_wait(sm.full(s), parity_of(it));
    wgmma_fence();
    tile_product<D>(sc, q_s, k_s);
    tile_product<D>(dp, do_s, v_s);
    // Step it - 1's dq product and step it's s are done.
    wgmma_wait<1>();
    fence_regs(sc);
    fence_regs(acc);
    if (it > 0) release(sm.empty(stage_of(it - 1)), lane);
    const bool edge = tile_edge(q0, s_len, q_glob, k0, kv_len, k_glob,
                                causal, window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * j + 2 * t4 + (e & 1);
        const int ql = r0 + g + (e >> 1) * 8;
        float pe = exp2f(sc[4 * j + e] * scale_l2 - lse_l2[e >> 1]);
        if (edge && !(q0 + ql < s_len && k0 + kl < kv_len &&
                      visible(q_glob + ql, k_glob + kl, causal, window)))
          pe = 0.f;
        sc[4 * j + e] = pe;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
    pack_frags(dp, da);
    wgmma_fence();
    acc_product<D>(acc, da, k_s);  // dq += ds K
  }
  if (n_items > 0) {
    wgmma_wait<0>();
    fence_regs(acc);
    release(sm.empty(stage_of(n_items - 1)), lane);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + g + h * 8;
    if (r >= s_len) continue;
    TO* out = dq + (static_cast<size_t>(bh) * s_len + r) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<TO>(out + j * 8, acc[4 * j + 2 * h] * sm_scale,
                 acc[4 * j + 2 * h + 1] * sm_scale);
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int b, hq, hkv, s_len, kv_len, causal, window, q_off, kv_off;
  float sm_scale;
  int n_split;
  cudaStream_t stream;
};

int n_tiles(int n) { return (n + kBQ - 1) / kBQ; }

template <int D, typename TO, bool kDkv>
int launch(const Args& a) {
  CUtensorMap qm, km, vm, dm;
  if (!head_map(&qm, a.q, a.b * a.hq, a.s_len, D) ||
      !head_map(&km, a.k, a.b * a.hkv, a.kv_len, D) ||
      !head_map(&vm, a.v, a.b * a.hkv, a.kv_len, D) ||
      !head_map(&dm, a.dout, a.b * a.hq, a.s_len, D))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = BwdLayout<D>::kSmem;
  if constexpr (kDkv) {
    constexpr auto kernel = flash_bwd_dkv_wgmma_kernel<D, TO>;
    allow_smem_once<kernel>(smem);
    kernel<<<dim3(a.b * a.hkv, n_tiles(a.kv_len), a.n_split), 256, smem,
             a.stream>>>(qm, km, vm, dm, a.lse, a.delta,
                         static_cast<TO*>(a.dk), static_cast<TO*>(a.dv), a.hq,
                         a.hkv, a.s_len, a.kv_len, a.causal, a.window,
                         a.sm_scale, a.q_off, a.kv_off);
  } else {
    constexpr auto kernel = flash_bwd_dq_wgmma_kernel<D, TO>;
    allow_smem_once<kernel>(smem);
    kernel<<<dim3(a.b * a.hq, n_tiles(a.s_len)), 256, smem, a.stream>>>(
        qm, km, vm, dm, a.lse, a.delta, static_cast<TO*>(a.dq), a.hq, a.hkv,
        a.s_len, a.kv_len, a.causal, a.window, a.sm_scale, a.q_off,
        a.kv_off);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kDkv>
int run(const Args& a, int d, int out_f32) {
  if (d == 128)
    return out_f32 ? launch<128, float, kDkv>(a) : launch<128, bf16, kDkv>(a);
  if (d == 64)
    return out_f32 ? launch<64, float, kDkv>(a) : launch<64, bf16, kDkv>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Pass A, split ``n_split`` ways over each kv head's n_rep query heads.
// bf16 q/dout [B, Hq, S, D], k/v [B, Hkv, Skv, D], lse/delta [B, Hq, S]
// float32; D 64 or 128, the bf16 bases 16-byte aligned; window 0 for none;
// q_off/kv_off the global positions of row 0 of q and of k.  Writes dk/dv
// [n_split, B, Hkv, Skv, D] in bf16, or float32 when out_f32: split z holds
// the sum over query heads [z * n_rep / n_split, (z + 1) * n_rep /
// n_split) of each kv head.  n_split must divide n_rep, and above 1 the
// outputs must be float32.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take or a tensor map
// cuTensorMapEncodeTiled refuses).
extern "C" int sw_flash_bwd_dkv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int hq,
    int hkv, int s_len, int kv_len, int d, int causal, int window, int q_off,
    int kv_off, float sm_scale, int out_f32, int n_split, void* stream) {
  if (n_split < 1 || (hq / hkv) % n_split || (n_split > 1 && !out_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, dk, dv, b, hq, hkv,
               s_len, kv_len, causal, window, q_off, kv_off, sm_scale,
               n_split, static_cast<cudaStream_t>(stream)};
  return run<true>(a, d, out_f32);
}

// Pass B.  Same inputs as pass A; writes dq [B, Hq, S, D] in bf16, or
// float32 when out_f32.
extern "C" int sw_flash_bwd_dq_wgmma(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int b, int hq, int hkv,
                                     int s_len, int kv_len, int d, int causal,
                                     int window, int q_off, int kv_off,
                                     float sm_scale, int out_f32,
                                     void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, b, hq,
               hkv, s_len, kv_len, causal, window, q_off, kv_off, sm_scale,
               1, static_cast<cudaStream_t>(stream)};
  return run<false>(a, d, out_f32);
}
