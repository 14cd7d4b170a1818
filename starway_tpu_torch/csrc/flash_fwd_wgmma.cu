// The bf16 flash-attention forward and the ring step's partial on Hopper's
// own tensor cores and copies: warpgroup matrix multiplies (wgmma) fed by
// TMA, as FlashAttention-3 lays the loop out.  The same functions as
// csrc/flash_fwd.cu's flash_fwd_mma_kernel and flash_partial_mma_kernel
// (causal or not, kv padding, sliding window, global [q_offset, kv_offset]
// coordinates, GQA with kv head h / n_rep; the forward's o and lse [B, Hq,
// S] float32, the partial's float32 (acc, m, l) with the identity acc = 0,
// m = NEG_BIG, l = 0 on rows that see no key), which stay for the head
// sizes this one does not take, 16 and 32 (ops/flash.py fwd_route).  Like
// them it takes 16-byte aligned bases only (TMA's terms); the wrappers
// refuse others.
//
// Replaces the TPU kernels starway_tpu/ops/pallas_attention.py _fwd_kernel
// (:124) and _partial_kernel (:580, entry flash_partial :640).
//
// What bounds it: operations (about 4 S^2 D flops a head against O(S D)
// bytes).  mma.sync, Ampere's instruction, runs on Hopper at well under
// its full rate; wgmma is the way to it, and TMA moves a tile with one
// thread's instruction and no registers.  The design:
//
// * A block is one (batch * q head, 64-row q tile): one producer
//   warpgroup, which gives up registers (setmaxnreg.dec to 24), and one
//   consumer warpgroup, which takes them (to 232); two blocks share an SM
//   and overlap each other's softmax and products.  Measured on the H100
//   (PERF.md §6), 128-row blocks of two consumers ran slower at every
//   main-path shape, with or without ping-pong turns between the two.
// * One thread of the producer loads q once and then every live 64-key K
//   and V tile into a two-stage ring by TMA (3D tensor maps over [B * H,
//   S, D]: rows past S or Skv arrive as zeros, and no tile crosses into the
//   next head), K and V each on their own mbarriers, so s = q k^T starts
//   before V lands and K is refilled a step before V; a stage is refilled
//   once every consumer warp has arrived on its "empty" barrier.  A tile
//   is D / 64 boxes of 64 rows x 128 bytes, 128-byte swizzled.
// * s = q k^T is wgmma.m64n64k16 with q and K both from shared memory,
//   K-major (D / 16 steps of 32 bytes along a box, then the next box).
// * The scores, the masks and the online softmax are the mma.sync loop's,
//   64 keys a step as there, so a row's result does not depend on the
//   kernel or the q-tile height: the wgmma accumulator's layout is
//   mma.sync's m16n8 tiles side by side (thread (g, t4) of warp w holds
//   rows 16 w + g (+ 8), columns 8 j + 2 t4 (+ 1)), live_range skips dead
//   tiles, masks apply only on tiles that tile_edge says cross the
//   diagonal, the band edge or an array end, and the row sums are reduced
//   over the quad in a fixed order at the end: the results are
//   bit-for-bit repeatable.  (128-key steps ran faster in 128-row blocks
//   but round p against another running max: the routing-sensitive MoE
//   checks of the mesh paths then moved past their limits.)
// * acc += p v is wgmma.m64n{D}k16 with p from registers, packed straight
//   from the score accumulator into the A fragments (two adjacent m16n8
//   score tiles are one m16k16 fragment), and V from shared memory as an
//   MN-major B (the transpose bit; atoms of 8 keys x 64 columns, 1024 bytes
//   apart along the keys, 8192 along D).
// * The consumer issues step it's s = q k^T beside step it - 1's p v, runs
//   step it's softmax while p v finishes, and only then rescales acc.
//
// Under causal masking the heaviest q tiles go first.  Shared memory at
// D = 128: q 16 KB and two stages of K and V, 16 KB each: 80 KB, two
// blocks an SM.  Registers: PERF.md's kernel table (ptxas -v for sm_90a,
// chip_smoke.py's report, "fwd wgmma" and "partial wgmma").
#include <math_constants.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kStages = 2;      // the K/V ring (3 ran no faster)
constexpr int kBox = 64 * 128;  // bytes of a 64-row, 128-byte box

template <int D>
struct FwdLayout {
  static constexpr int kTile = 64 * D * 2;  // a [64][D] bf16 tile
  static constexpr int kBars = 1 + 4 * kStages;
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(1 + 2 * kStages) * kTile + 8 * kBars;
};

// The tile loop of one (batch * q head, 64-row q tile) block and its
// epilogue: kPartial selects the ring step's (acc, m, l) over (o, lse).
// Grid (B * Hq, q tiles).
template <int D, bool kPartial>
__device__ __forceinline__ void flash_tiles_wgmma(
    const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, void* __restrict__ o_out,
    float* __restrict__ row_a, float* __restrict__ row_b, int hq, int hkv,
    int s_len, int kv_len, int causal, int window, float sm_scale,
    int q_off, int kv_off) {
  using L = FwdLayout<D>;
  constexpr int CB = D / 64;  // boxes a row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t q_s = smem_u32(sm);               // [CB][64][64]
  const uint32_t k_s = q_s + L::kTile;             // [kStages][CB][64][64]
  const uint32_t v_s = k_s + kStages * L::kTile;   // [kStages][CB][64][64]
  const uint32_t bar = v_s + kStages * L::kTile;   // mbarriers, 8 bytes each
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bar + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar + 8 * (1 + 3 * kStages + s); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = bh / hq;
  const int kvh = b * hkv + (bh - b * hq) / (hq / hkv);
  const int n_k = (kv_len + kBK - 1) / kBK;
  int lo, hi;  // the live kv tiles
  live_range(n_k, kv_off, q_off + q0, false, causal, window, &lo, &hi);
  const int n_steps = hi < lo ? 0 : hi - lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4);  // every consumer warp
      mbar_init(v_empty(s), 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_steps > 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int cb = 0; cb < CB; ++cb)
        tma_load_3d(q_s + cb * kBox, q_map, q_full, cb * 64, q0, bh);
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % kStages;
        const uint32_t done = ((it / kStages) - 1) & 1;
        const int k0 = (lo + it) * kBK;
        if (it >= kStages) mbar_wait(k_empty(s), done);
        mbar_expect_tx(k_full(s), L::kTile);
        for (int cb = 0; cb < CB; ++cb)
          tma_load_3d(k_s + s * L::kTile + cb * kBox, k_map, k_full(s),
                      cb * 64, k0, kvh);
        if (it >= kStages) mbar_wait(v_empty(s), done);
        mbar_expect_tx(v_full(s), L::kTile);
        for (int cb = 0; cb < CB; ++cb)
          tma_load_3d(v_s + s * L::kTile + cb * kBox, v_map, v_full(s),
                      cb * 64, k0, kvh);
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
  const int r0 = 16 * warp;  // the warp's rows of the tile

  float acc[D / 2];  // [D / 8 n8 tiles][4]: rows r0 + g (+ 8)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_row[2] = {SW_NEG_BIG, SW_NEG_BIG};
  float l_row[2] = {0.f, 0.f};
  const float scale_l2 = sm_scale * kLog2e;
  if (n_steps > 0) mbar_wait(q_full, 0);

  auto stage = [](int it) { return it % kStages; };
  auto parity = [](int it) { return static_cast<uint32_t>(it / kStages) & 1; };
  auto release = [&](uint32_t b) {
    __syncwarp();
    if (lane == 0) mbar_arrive(b);
  };
  // s = q k^T of step it, issued (one wgmma group).
  auto scores = [&](int it, float (&sc)[32]) {
    mbar_wait(k_full(stage(it)), parity(it));
    const uint32_t ks = k_s + stage(it) * L::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
      wgmma_ss_n64(sc, gmma_desc(q_s + off, 16, 1024),
                   gmma_desc(ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // acc += p v of step it, issued (one wgmma group).
  auto products = [&](int it, const uint32_t (&pa)[4][4]) {
    mbar_wait(v_full(stage(it)), parity(it));
    const uint32_t vs = v_s + stage(it) * L::kTile;
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      const uint64_t dv = gmma_desc(vs + kq * 2048, kBox, 1024);
      if constexpr (D == 128)
        wgmma_rs_n128<1>(acc, pa[kq], dv, 1);
      else
        wgmma_rs_n64<1>(acc, pa[kq], dv, 1);
    }
    wgmma_commit();
  };
  // The masks and the online softmax of step it's scores: sc becomes p,
  // m_row and l_row move on, and corr is what acc must be scaled by.
  auto softmax = [&](int it, float (&sc)[32], float (&corr)[2]) {
    const int k0 = (lo + it) * kBK;
    const int k_glob = kv_off + k0;
    if (tile_edge(q0, s_len, q_off + q0, k0, kv_len, k_glob, causal,
                  window)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = j * 8 + 2 * t4 + (e & 1);
          const int ql = r0 + g + (e >> 1) * 8;
          if (!(q0 + ql < s_len && k0 + kl < kv_len &&
                visible(q_off + q0 + ql, k_glob + kl, causal, window)))
            sc[4 * j + e] = -CUDART_INF_F;
        }
    }
    // Rows g (h = 0) and g + 8 (h = 1).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // max(s) * scale is max(s * scale): rounding is monotone.  A row
      // that sees no key yet keeps m = NEG_BIG.
      const float m_new = fmaxf(m_row[h], mx * sm_scale);
      // A row whose window starts in a later tile is fully masked here:
      // with the clamp its p stays exactly 0 (its scores are -inf).
      const float m_l2 = fmaxf(m_new, SW_NEG_BIG / 2) * kLog2e;
      corr[h] = exp2f((m_row[h] - m_new) * kLog2e);
      m_row[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          sc[4 * j + e] = exp2f(fmaf(sc[4 * j + e], scale_l2, -m_l2));
          sum += sc[4 * j + e];
        }
      l_row[h] = l_row[h] * corr[h] + sum;
    }
  };
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
  };

  if (n_steps > 0) {
    // Step it's scores run on the tensor cores while step it - 1's p v
    // does, and its softmax while p v finishes.  The loop is straight-line
    // code: wgmmas in data-dependent branches make ptxas serialize them.
    float sc[32];  // [8 key n8 tiles][4]: q . k, then p
    float corr[2];
    uint32_t pa[4][4];
    scores(0, sc);
    wgmma_wait<0>();
    fence_regs(sc);
    release(k_empty(stage(0)));
    softmax(0, sc, corr);
    pack_frags(sc, pa);  // p in bf16: the A fragments of p v
    for (int it = 1; it < n_steps; ++it) {
      scores(it, sc);
      products(it - 1, pa);
      wgmma_wait<1>();
      fence_regs(sc);
      release(k_empty(stage(it)));
      softmax(it, sc, corr);
      wgmma_wait<0>();
      fence_regs(acc);
      release(v_empty(stage(it - 1)));
      rescale(corr);
      pack_frags(sc, pa);
    }
    products(n_steps - 1, pa);
    wgmma_wait<0>();
    fence_regs(acc);
    release(v_empty(stage(n_steps - 1)));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // The row sum over the quad, in a fixed order.
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = q0 + r0 + g + h * 8;
    if (r >= s_len) continue;
    const size_t row = static_cast<size_t>(bh) * s_len + r;
    if constexpr (kPartial) {
      float* ob = static_cast<float*>(o_out) + row * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2<float>(ob + j * 8, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (t4 == 0) {
        row_a[row] = m_row[h];
        row_b[row] = l;
      }
    } else {
      bf16* ob = static_cast<bf16*>(o_out) + row * D + 2 * t4;
      l = fmaxf(l, 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2<bf16>(ob + j * 8, acc[4 * j + 2 * h] / l,
                     acc[4 * j + 2 * h + 1] / l);
      if (t4 == 0) row_a[row] = m_row[h] + logf(l);
    }
  }
}

// 256 threads: the producer warpgroup, then the consumer; two blocks an SM.
template <int D>
__global__ void __launch_bounds__(256, 2)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int hq, int hkv, int s_len, int kv_len,
                           int causal, int window, float sm_scale) {
  flash_tiles_wgmma<D, false>(&q_map, &k_map, &v_map, o, lse, nullptr, hq,
                              hkv, s_len, kv_len, causal, window, sm_scale,
                              0, 0);
}

template <int D>
__global__ void __launch_bounds__(256, 2)
    flash_partial_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               float* __restrict__ acc,
                               float* __restrict__ m, float* __restrict__ l,
                               int hq, int hkv, int s_len, int kv_len,
                               int causal, int window, float sm_scale,
                               int q_off, int kv_off) {
  flash_tiles_wgmma<D, true>(&q_map, &k_map, &v_map, acc, m, l, hq, hkv,
                             s_len, kv_len, causal, window, sm_scale, q_off,
                             kv_off);
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v;
  void* o;               // o (bf16) or the partial's acc (float32)
  float *row_a, *row_b;  // lse, or the partial's m and l
  int b, hq, hkv, s_len, kv_len, causal, window, q_off, kv_off;
  float sm_scale;
  cudaStream_t stream;
};

template <int D, bool kPartial>
int launch(const Args& a) {
  using L = FwdLayout<D>;
  CUtensorMap qm, km, vm;
  if (!head_map(&qm, a.q, a.b * a.hq, a.s_len, D) ||
      !head_map(&km, a.k, a.b * a.hkv, a.kv_len, D) ||
      !head_map(&vm, a.v, a.b * a.hkv, a.kv_len, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.b * a.hq, (a.s_len + kBQ - 1) / kBQ);
  if constexpr (kPartial) {
    constexpr auto kernel = flash_partial_wgmma_kernel<D>;
    allow_smem_once<kernel>(L::kSmem);
    kernel<<<grid, 256, L::kSmem, a.stream>>>(
        qm, km, vm, static_cast<float*>(a.o), a.row_a, a.row_b, a.hq, a.hkv,
        a.s_len, a.kv_len, a.causal, a.window, a.sm_scale, a.q_off,
        a.kv_off);
  } else {
    constexpr auto kernel = flash_fwd_wgmma_kernel<D>;
    allow_smem_once<kernel>(L::kSmem);
    kernel<<<grid, 256, L::kSmem, a.stream>>>(
        qm, km, vm, static_cast<bf16*>(a.o), a.row_a, a.hq, a.hkv, a.s_len,
        a.kv_len, a.causal, a.window, a.sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kPartial>
int run(const Args& a, int d) {
  if (d == 128) return launch<128, kPartial>(a);
  if (d == 64) return launch<64, kPartial>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16 q [B, Hq, S, D], k/v [B, Hkv, Skv, D], o like q, lse [B, Hq, S]
// float32; D 64 or 128, every base 16-byte aligned; window 0 for none.
// q tiles of 64 rows.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take or a tensor map
// cuTensorMapEncodeTiled refuses).
extern "C" int sw_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int b, int hq, int hkv,
                                  int s_len, int kv_len, int d, int causal,
                                  int window, float sm_scale, void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), nullptr, b, hq, hkv,
               s_len, kv_len, causal, window, 0, 0, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, d);
}

// One ring step: q [B, Hq, S, D] at global position q_off against k/v
// [B, Hkv, Skv, D] at kv_off; writes acc [B, Hq, S, D], m and l [B, Hq, S],
// all float32.  Otherwise as sw_flash_fwd_wgmma.
extern "C" int sw_flash_partial_wgmma(const void* q, const void* k,
                                      const void* v, void* acc, void* m,
                                      void* l, int b, int hq, int hkv,
                                      int s_len, int kv_len, int d,
                                      int causal, int window, int q_off,
                                      int kv_off, float sm_scale,
                                      void* stream) {
  const Args a{q, k, v, acc, static_cast<float*>(m), static_cast<float*>(l),
               b, hq, hkv, s_len, kv_len, causal, window, q_off, kv_off,
               sm_scale, static_cast<cudaStream_t>(stream)};
  return run<true>(a, d);
}
