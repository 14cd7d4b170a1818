// Cached GQA decode attention in its decode regime (n_rep * C <= 16 query
// rows per (batch row, kv head)) at head sizes 64 and 128, bf16 queries
// over bf16 or int8 caches, on Hopper's own copies and tensor cores: the
// K/V stream by TMA into a ring under mbarriers, the products on wgmma
// with the keys as M, and a split over T as wide as the card, merged in a
// fixed order.  csrc/decode_attention.cu's decode_mma_kernel keeps the
// ingest regime (more rows), the head sizes 16, 32 and 256, and float32
// (ops/decode.py tma_route).
//
// Replaces the TPU kernels starway_tpu/ops/pallas_decode.py
// _decode_stream_kernel (:150) and _decode_kernel (:107) on the path they
// serve most: every decode step of every dense server and the chunk
// verify at C <= 4.  The function is decode_mma_kernel's: query rows
// r = rep * C + ci at position pos + r % C, causal and window masks,
// float32 scores and online softmax, an int8 cache's k_scale folded into
// the score columns and its v_scale into p after l is summed, and p
// rounded to bf16 before p v.
//
// What bounds it: device-memory bytes.  A call streams the live keys of
// each (batch row, kv head) once, with n_rep * C multiply-adds an element,
// far below the card's ~295 FLOP/byte.  The mma.sync kernel reached 0.43
// to 0.46 of that bound at the serving shape: a block's 2-stage cp.async
// ring filled by its own 128 threads, 12 of mma's 16 rows dead at C = 1,
// and the split over T capped at one 16-block cluster (32 blocks on 132
// SMs at B = 1, 2 kv heads).  The design:
//
// * A block is 256 threads: a producer warpgroup that gives up registers
//   (setmaxnreg.dec to 24), of which one warp works, and one consumer
//   warpgroup that takes them (setmaxnreg.inc).  Three blocks share an SM
//   where each keeps a ring of 3 or more stages (int8 caches, D = 64), two
//   at bf16 D = 128 (measured on the H100, PERF.md: one block of 6 stages
//   an SM ran no faster than two of 3; three of 2 stages, a little
//   faster, fall short of the 3-stage ring).
// * Lane 0 of the producer loads every tile of the block's share by TMA
//   (3-D tensor maps over [B * Hkv, T, D]: bf16 in boxes of 64 columns,
//   int8 in one box of D bytes a row; rows past T arrive as zeros) into the
//   ring, K and V each on their own "full" barrier, so the scores start
//   before V lands; a stage is refilled once every consumer warp has
//   arrived on its "empty" barrier.  An int8 tile's 64 k and v scales are
//   copied by the producer's lanes with plain loads while its TMA is in
//   flight.  The consumers issue no copy and compute no address of the
//   stream.
// * s^T = K q^T is wgmma.m64nNk16 with the tile's 64 keys as M and the
//   query rows as N (8 up to 8 rows, else 16), its even and odd k16 steps
//   in two chains: K from shared memory, K-major (bf16), or widened from
//   int8 in registers as A (the head dimension permuted inside each k16
//   step so that a thread's four values are one 32-bit read; q is stored
//   with the same permutation); q a K-major B.  o^T += V^T p^T is
//   wgmma.m64nNk16 once or twice (D / 64) a k16 step: V as an MN-major A
//   (bf16: the transpose bit) or widened in registers (int8: the output
//   rows permuted so that one 32-bit read of a key row serves all of a
//   thread's rows), p^T a K-major B that the consumers write to shared
//   memory in bf16.  No row of a product is dead but the query columns
//   past n_rep * C.
// * The softmax's running max is the warpgroup's: each warp's column max
//   over its 16 keys goes through shared memory.  The loop is pipelined
//   so that one named barrier a tile serves both that exchange and p^T:
//   tile it's scores are issued, tile it - 1's p^T written and its V made
//   ready, the barrier passed, then tile it - 1's p v issued and tile it's
//   softmax run.  Masks are selects (a masked score is -inf, a masked
//   key's v-scaled p is 0), and the V rows of keys outside the block's
//   live range are zeroed in shared memory before p v, so nothing past the
//   live keys (a fresh cache, a rolling cache's other slots, NaN) reaches
//   the result.
// * The split over T: ops/decode.py tma_plan gives n_split blocks to each
//   (batch row, kv head) from the shapes only (about 4 tiles a split of
//   the longest row, at least a block an SM).  Each block finds its share
//   of the live tiles from pos on the device: split z takes tiles
//   [z per, (z + 1) per) of the T live ones, per = ceil(T_max / n_split)
//   with T_max the most tiles a row can have (the cache's, or the
//   window's), and the blocks past ceil(T / per) have none and leave at
//   once: a short row of a ragged batch takes few blocks and few partials.
//   Where one block has every live tile it writes the output itself;
//   otherwise each block leaves a float32 (o, m, l) partial in the
//   workspace the wrapper allocates (one a card and stream: ops/decode.py
//   _workspace) and takes a ticket (an atomic counter
//   a (batch row, kv head), one row of counters a stream, reset by the
//   block that takes the last ticket; its acquire-release add publishes
//   the partial), and the last block merges the partials in split order
//   with weight exp(m_z - M), normalises by max(l, 1e-30) and writes q's
//   dtype.  Past 32 busy splits one SM reading every partial is slower
//   than two levels: the last block of each group of 8 splits merges the
//   group's in split order, and the last of those the groups in group
//   order.  Every sum runs in a fixed order: two calls give identical
//   bits.  (A merge over distributed shared memory in clusters of 8 ran
//   slower: PERF.md.)
// * The launch is a programmatic dependent one: blocks start while the
//   kernel before them finishes and wait (griddepcontrol.wait) before
//   reading anything it wrote.
//
// Layouts: q [B, Hq, C, D] read as [B * Hkv, R = n_rep * C, D]; caches
// [B * Hkv, T, D]; scales [B * Hkv, T] float32; pos [B] int32 (or one
// value); the partials o [B * Hkv, n_split, R, D], then m and l [B * Hkv,
// n_split, R], float32.  Registers and shared memory: PERF.md's kernel
// table (ptxas -v for sm_90a, chip_smoke.py's report, "decode tma").
#include <math_constants.h>

#include <map>
#include <mutex>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTmaKeys = 64;          // keys a tile
constexpr int kTmaThreads = 256;      // producer and consumer warpgroups
constexpr int kProducerRegs = 24;     // registers a producer thread
constexpr int kMaxTmaSplits = 256;    // ops/decode.py TMA_MAX_SPLITS
constexpr int kSingleMerge = 32;      // ops/decode.py TMA_SINGLE_MERGE
constexpr int kMergeGroup = 8;        // ops/decode.py TMA_MERGE_GROUP
constexpr int kGroups = kMaxTmaSplits / kMergeGroup;
constexpr int kTicketStreams = 16;    // rows of counters (streams)
constexpr int kTicketPairs = 1024;    // (batch row, kv head) pairs a row
constexpr int kBarId = 1;             // the consumers' named barrier

// A (batch row, kv head)'s counters: the last merge's, then one a group
// of kMergeGroup splits.  Zero at load; each merge leaves its counter at
// zero again.
__device__ unsigned int
    g_tickets[kTicketStreams * kTicketPairs * (1 + kGroups)];

template <typename TKV, int D, int N>
struct TmaShape {
  static constexpr bool kInt8 = sizeof(TKV) == 1;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TKV));
  static constexpr int kBoxes = kInt8 ? 1 : D / 64;  // TMA boxes a tile
  static constexpr int kBox = kTmaKeys * kRowBytes / kBoxes;
  static constexpr int kTile = kTmaKeys * kRowBytes;
  static constexpr int kQBox = N * 128;  // a [N][64] bf16 box of q
  // Blocks an SM: three, each with a ring of 3 to 8 stages, where that
  // fits (int8 caches, D = 64); two at bf16 D = 128, whose 32 KB stages
  // would leave three blocks a ring of 2.  Each block takes as many stages
  // as fit in its share of the SM's 228 KB (less 1 KB a block, the
  // alignment and everything but the ring).
  static constexpr int kBlocks = (kInt8 || D == 64) ? 3 : 2;
  static constexpr int kFixed = 1024 + (D / 64) * kQBox + 2 * N * 128 +
                                2 * 4 * N * 4 + 16 + 8 * 4 * 8;
  static constexpr int kAvail = 233472 / kBlocks - 1024 - kFixed;
  static constexpr int kFit = kAvail / (2 * kTile + (kInt8 ? 512 : 0));
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static_assert(kStages >= 3, "a ring of at least 3 stages");
  // Registers a consumer thread: its own and a producer thread's at launch
  // (65536 / (256 kBlocks) each, in steps of 8), less the producer's 24.
  static constexpr int kLaunchRegs = (65536 / (256 * kBlocks)) / 8 * 8;
  static constexpr int kConsumerRegs =
      (2 * kLaunchRegs - kProducerRegs) / 8 * 8;
  static constexpr int kOffV = kStages * kTile;
  static constexpr int kOffQ = 2 * kStages * kTile;
  // p^T [2][N][64] bf16, double-buffered as the tile loop is pipelined.
  static constexpr int kOffP = kOffQ + (D / 64) * kQBox;
  static constexpr int kOffScales = kOffP + 2 * N * 128;  // [stage][k, v][64]
  static constexpr int kOffRed = kOffScales + (kInt8 ? kStages * 512 : 0);
  static constexpr int kOffFlag = kOffRed + 2 * 4 * N * 4;  // red [2][4][N]
  static constexpr int kOffBar = kOffFlag + 16;
  static constexpr size_t kSmem = 1024 + kOffBar + 8 * 4 * kStages;
  static_assert(kSmem + 1024 <= 233472 / kBlocks, "kBlocks blocks fit");
  // The merge's arrays (m or w, and l, a split and row; M a row) take
  // over the ring once the tile loop is done.
  static_assert((2 * kMaxTmaSplits + 1) * N * 4 <= kOffQ,
                "the merge's arrays fit in the ring");
};

struct TmaArgs {
  const bf16* q;
  const float* k_scale;
  const float* v_scale;
  const int* pos;  // [B] (pos_stride 1), one value (0), or nullptr
  int pos_stride;
  int pos_value;   // the position of every row where pos is nullptr
  bf16* out;
  float* part;     // the partials, or nullptr where n_split is 1
  int ticket_row;  // the stream's row of g_tickets
  int hkv, rows, n_q, t_len, window;
  float sm_scale;
};

// Programmatic dependent launch: the kernel is launched with the
// attribute, so its blocks may start while the kernel ahead of it in the
// stream (which wrote q, pos and the caches) finishes; griddep_wait()
// returns once that kernel has completed and its writes are visible.
// griddep_launch() lets the next such kernel start once every block has
// issued it or exited.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Byte ``byte`` of row ``r`` of an int8 tile of D-byte rows as the TMA
// stored it (128-byte swizzle at D = 128, 64-byte at D = 64).
template <int D>
__device__ __forceinline__ uint32_t swz8(int r, int byte) {
  const uint32_t l = static_cast<uint32_t>(r * D + byte);
  constexpr uint32_t m = D == 128 ? 7 : 3;
  return l ^ (((l >> 7) & m) << 4);
}

// Byte ``byte`` (< 128) of row ``r`` of a box of 128-byte rows.
__device__ __forceinline__ uint32_t swz128(int r, int byte) {
  return r * 128 + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void mma_ss<8>(float (&d)[4], uint64_t da,
                                          uint64_t db, int scale_d) {
  wgmma_ss_n8<0>(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void mma_ss<16>(float (&d)[8], uint64_t da,
                                           uint64_t db, int scale_d) {
  wgmma_ss_n16<0>(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void mma_ts(float (&d)[N / 2], uint64_t da,
                                       uint64_t db);
template <>
__device__ __forceinline__ void mma_ts<8>(float (&d)[4], uint64_t da,
                                          uint64_t db) {
  wgmma_ss_n8<1>(d, da, db, 1);
}
template <>
__device__ __forceinline__ void mma_ts<16>(float (&d)[8], uint64_t da,
                                           uint64_t db) {
  wgmma_ss_n16<1>(d, da, db, 1);
}
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d);
template <>
__device__ __forceinline__ void mma_rs<8>(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  wgmma_rs_n8(d, a, db, scale_d);
}
template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  wgmma_rs_n16(d, a, db, scale_d);
}

// Partials merged in their order with weight exp(m_i - M): ``cnt`` of
// them, partial i's row n at o0 + (i rows + n) D, m0[i rows + n] and
// l0[i rows + n].  The m and l rows go to shared memory, each row's M is
// found by a warp and the weights by every thread; then each thread owns
// float4 columns of the result (column tid + 128 i, CPT of them), whose
// partials it reads ZB at a time, every load of a round in flight at once
// (the first round issued before the weights).  The result is the output
// (bf16, normalised by max(l, 1e-30); ``out`` not null) or, for a group of
// splits, a partial of the same form (go, gm, gl).
template <int D, int N, int CPT>
__device__ __forceinline__ void merge_parts(
    const float* o0, const float* m0, const float* l0, int cnt, int rows,
    unsigned char* sm, int tid, bf16* out, float* go, float* gm, float* gl) {
  constexpr int C4 = D / 4;  // float4 columns a row
  constexpr int ZB = 16 / CPT;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* w_s = reinterpret_cast<float*>(sm);  // [part][N]: m, then w
  float* l_s = w_s + kMaxTmaSplits * N;       // [part][N]
  float* mx_s = l_s + kMaxTmaSplits * N;      // [N]
  const int n_cols = rows * C4;
  float4 buf[CPT][ZB];
  auto fetch = [&](int z0) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int u = 0; u < ZB; ++u) {
        const int col = tid + 128 * i;
        if (col < n_cols && z0 + u < cnt)
          buf[i][u] = __ldcg(reinterpret_cast<const float4*>(
                                 o0 + static_cast<size_t>(z0 + u) * rows *
                                          D) +
                             col);
      }
  };
  fetch(0);
#pragma unroll 4
  for (int i = tid; i < cnt * rows; i += 128) {
    const int z = i / rows;
    w_s[z * N + i - z * rows] = __ldcg(m0 + i);
    l_s[z * N + i - z * rows] = __ldcg(l0 + i);
  }
  named_barrier(kBarId, 128);
  for (int n = warp; n < rows; n += 4) {  // max is exact in any order
    float mx = -CUDART_INF_F;
    for (int z = lane; z < cnt; z += 32) mx = fmaxf(mx, w_s[z * N + n]);
#pragma unroll
    for (int o = 16; o; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) mx_s[n] = mx;
  }
  named_barrier(kBarId, 128);
  for (int i = tid; i < cnt * rows; i += 128) {
    const int z = i / rows;
    const int n = i - z * rows;
    w_s[z * N + n] = exp2f((w_s[z * N + n] - mx_s[n]) * kLog2e);
  }
  named_barrier(kBarId, 128);
  int row[CPT];
  float l[CPT];
  float4 o[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    row[i] = min((tid + 128 * i) / C4, rows - 1);
    l[i] = 0.f;
    o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int z0 = 0; z0 < cnt; z0 += ZB) {
    if (z0 > 0) fetch(z0);
    const int nz = min(ZB, cnt - z0);
    float wz[CPT][ZB], lz[CPT][ZB];
#pragma unroll
    for (int u = 0; u < ZB; ++u)
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int at = (z0 + (u < nz ? u : 0)) * N + row[i];
        wz[i][u] = w_s[at];
        lz[i][u] = l_s[at];
      }
#pragma unroll
    for (int u = 0; u < ZB; ++u) {
      if (u >= nz) break;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const float w = wz[i][u];
        l[i] = fmaf(lz[i][u], w, l[i]);
        o[i].x = fmaf(buf[i][u].x, w, o[i].x);
        o[i].y = fmaf(buf[i][u].y, w, o[i].y);
        o[i].z = fmaf(buf[i][u].z, w, o[i].z);
        o[i].w = fmaf(buf[i][u].w, w, o[i].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int col = tid + 128 * i;
    if (col >= n_cols) continue;
    const int c4 = col - row[i] * C4;
    if (out != nullptr) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      bf16* dst = out + row[i] * D + 4 * c4;
      store2<bf16>(dst, o[i].x * inv, o[i].y * inv);
      store2<bf16>(dst + 2, o[i].z * inv, o[i].w * inv);
    } else {
      reinterpret_cast<float4*>(go + row[i] * D)[c4] = o[i];
      if (c4 == 0) {
        gm[row[i]] = mx_s[row[i]];
        gl[row[i]] = l[i];
      }
    }
  }
}

// Grid (n_split, B * Hkv).  N: the query rows padded to a product's width.
template <typename TKV, int D, int N>
__global__ void __launch_bounds__(kTmaThreads, (TmaShape<TKV, D, N>::kBlocks))
    decode_tma_kernel(const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const TmaArgs a) {
  using L = TmaShape<TKV, D, N>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int S = L::kStages;
  constexpr int NJ = N / 8;     // n8 column blocks of a product
  constexpr int MB = D / 64;    // m64 row blocks of o^T
  constexpr int KD = D / 16;    // k16 steps of s^T = K q^T
  constexpr int G = D / 32;     // int8 V: output rows a thread holds
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t k_s = smem_u32(sm);
  const uint32_t v_s = k_s + L::kOffV;
  const uint32_t q_s = k_s + L::kOffQ;
  const uint32_t p_s = k_s + L::kOffP;
  float* scales = reinterpret_cast<float*>(sm + L::kOffScales);
  float* red = reinterpret_cast<float*>(sm + L::kOffRed);  // [2][4 warps][N]
  int* flag = reinterpret_cast<int*>(sm + L::kOffFlag);
  const uint32_t bar = k_s + L::kOffBar;
  auto k_full = [&](int s) { return bar + 8 * s; };
  auto v_full = [&](int s) { return bar + 8 * (S + s); };
  auto k_empty = [&](int s) { return bar + 8 * (2 * S + s); };
  auto v_empty = [&](int s) { return bar + 8 * (3 * S + s); };

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bh = blockIdx.y;
  const int n_bh = gridDim.y;
  const int rows = a.rows;
  if (threadIdx.x == 0) {  // the maps' descriptors, ahead of the first TMA
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&k_map) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&v_map) : "memory");
  }
  griddep_wait();  // nothing the previous kernel wrote is read before
  // The consumers' chunks of q's rows (16 bytes each, rows past R zero),
  // loaded beside pos.
  constexpr int kQChunks = D / 8;  // 16-byte chunks a row
  constexpr int kQPer = (N * kQChunks + 127) / 128;
  uint4 q_in[kQPer];
  if (threadIdx.x >= 128) {
    const bf16* qb = a.q + static_cast<size_t>(bh) * rows * D;
#pragma unroll
    for (int k = 0; k < kQPer; ++k) {
      const int i = threadIdx.x - 128 + 128 * k;
      const int n = i / kQChunks;
      q_in[k] = make_uint4(0, 0, 0, 0);
      if (i < N * kQChunks && n < rows)
        q_in[k] = *reinterpret_cast<const uint4*>(
            qb + n * D + (i - n * kQChunks) * 8);
    }
  }
  const int pos =
      a.pos ? a.pos[bh / a.hkv * a.pos_stride] : a.pos_value;
  // The live keys of the block's rows, [k_lo, k_end), and its share.
  const int k_end = min(pos + a.n_q, a.t_len);
  const int k_lo = a.window > 0 ? max(pos - a.window + 1, 0) : 0;
  const int t_first = k_lo / kTmaKeys;
  const int n_tiles = max((k_end + kTmaKeys - 1) / kTmaKeys - t_first, 0);
  // A share is sized from the most tiles a row can have (the cache's, or
  // the window's), so a short row of a ragged batch takes few blocks.
  const int cap = (a.t_len + kTmaKeys - 1) / kTmaKeys;
  const int reach = a.window > 0
                        ? min(cap, (a.window + a.n_q - 1) / kTmaKeys + 2)
                        : cap;
  const int per = (reach + n_split - 1) / n_split;
  const int n_busy = n_tiles > 0 ? (n_tiles + per - 1) / per : 1;
  if (split >= n_busy) return;
  const int first = t_first + split * per;
  const int n_items = max(min(per, n_tiles - split * per), 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 32);  // the producer warp's lanes
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4);  // every consumer warp
      mbar_init(v_empty(s), 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---------------------------------- producer
    setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      for (int it = 0; it < n_items; ++it) {
        const int s = it % S;
        const uint32_t done = ((it / S) - 1) & 1;
        const int k0 = (first + it) * kTmaKeys;
        if (it >= S) mbar_wait(k_empty(s), done);
        if (lane == 0) {
          mbar_expect_bytes(k_full(s), L::kTile);
          for (int cb = 0; cb < L::kBoxes; ++cb)
            tma_load_3d(k_s + s * L::kTile + cb * L::kBox, &k_map,
                        k_full(s), cb * 64, k0, bh);
        }
        if constexpr (kInt8) {
          float* sc = scales + s * 128;
          const size_t row0 = static_cast<size_t>(bh) * a.t_len + k0;
          for (int i = lane; i < kTmaKeys; i += 32) {
            const bool ok = k0 + i < a.t_len;
            sc[i] = ok ? a.k_scale[row0 + i] : 0.f;
            sc[kTmaKeys + i] = ok ? a.v_scale[row0 + i] : 0.f;
          }
        }
        mbar_arrive(k_full(s));
        if (it >= S) mbar_wait(v_empty(s), done);
        if (lane == 0) {
          mbar_expect_tx(v_full(s), L::kTile);
          for (int cb = 0; cb < L::kBoxes; ++cb)
            tma_load_3d(v_s + s * L::kTile + cb * L::kBox, &v_map,
                        v_full(s), cb * 64, k0, bh);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumer
  setmaxnreg_inc<L::kConsumerRegs>();
  const int tid = threadIdx.x - 128;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // q's rows into shared memory as a K-major B: boxes of [N][64] bf16,
  // 128-byte swizzled, rows past R zero; for int8 K each k16 step's
  // columns in the order the widened A fragments read them (actual
  // columns 4 t .. 4 t + 3 are logical 2 t, 2 t + 1, 2 t + 8, 2 t + 9).
#pragma unroll
  for (int k = 0; k < kQPer; ++k) {
    const int i = tid + 128 * k;
    if (i >= N * kQChunks) break;
    const int n = i / kQChunks;
    const int c = i - n * kQChunks;
    const uint4 x = q_in[k];
    if constexpr (kInt8) {
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int aw = 4 * c + e;  // the actual word (two columns)
        const int lw = ((aw & 7) >> 1) + 4 * (aw & 1);
        const int col = (aw >> 3) * 16 + 2 * lw;  // the logical column
        const uint32_t at =
            q_s + (col >> 6) * L::kQBox + swz128(n, (col & 63) * 2);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(w[e]));
      }
    } else {
      const uint32_t at = q_s + (c >> 3) * L::kQBox + swz128(n, (c & 7) * 16);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                   "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w));
    }
  }
  fence_proxy_async();
  named_barrier(kBarId, 128);

  // This thread's columns n = 8 j + 2 t4 + c: the position of query row
  // n and the last key below its window (none visible past R).
  int q_hi[NJ][2], q_lo[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = 8 * j + 2 * t4 + c;
      q_hi[j][c] = n < rows ? pos + n % a.n_q : -1;
      q_lo[j][c] = a.window > 0 ? q_hi[j][c] - a.window : -1;
    }
  // o^T: accumulator row block mb holds output row (a head column) 64 mb +
  // 16 warp + g + 8 h (int8 V: G (8 warp + g) + 2 mb + h), columns as s^T.
  float acc[MB][N / 2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mb][i] = 0.f;
  float m_col[NJ][2], l_col[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      m_col[j][c] = SW_NEG_BIG;
      l_col[j][c] = 0.f;
    }
  const float scale_l2 = a.sm_scale * kLog2e;
  const int key0 = 16 * warp + g;  // this thread's keys: key0, key0 + 8

  auto release = [&](uint32_t b) {
    __syncwarp();
    if (lane == 0) mbar_arrive(b);
  };

  // The tile loop, software-pipelined: tile it's scores are issued, then
  // tile it - 1's p^T is written and its V made ready, then one named
  // barrier serves both (p^T visible to every warp, tile it's column maxima
  // exchanged), then tile it - 1's p v is issued and tile it's softmax run.
  uint32_t ka[kInt8 ? KD : 1][4];
  uint32_t va[kInt8 ? 4 : 1][kInt8 ? MB : 1][4];
  float sc[N / 2], sc2[N / 2];  // s^T of the tile issued last
  float pc[N / 2];              // p of the tile before it
  float corr[NJ][2];            // what acc is scaled by before its p v
  float ksc[2], vsc[2];         // int8: this thread's keys' scales
  // s^T = K q^T: rows key0 (+ 8), columns 8 j + 2 t4 (+ 1); the even and
  // the odd k16 steps in two chains, added when done.
  auto issue_scores = [&](int it) {
    const int s = it % S;
    mbar_wait(k_full(s), (it / S) & 1);
    if constexpr (kInt8) {
      const unsigned char* kb = sm + s * L::kTile;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
            kb + swz8<D>(key0, kk * 16 + 4 * t4));
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(
            kb + swz8<D>(key0 + 8, kk * 16 + 4 * t4));
        ka[kk][0] = widen2(w1, w1, 0x0100u);
        ka[kk][1] = widen2(w2, w2, 0x0100u);
        ka[kk][2] = widen2(w1, w1, 0x0302u);
        ka[kk][3] = widen2(w2, w2, 0x0302u);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint64_t dq =
            gmma_desc(q_s + (kk >> 2) * L::kQBox + (kk & 3) * 32, 16, 1024);
        if (kk & 1)
          mma_rs<N>(sc2, ka[kk], dq, kk > 1);
        else
          mma_rs<N>(sc, ka[kk], dq, kk > 0);
      }
    } else {
      const uint32_t kt = k_s + s * L::kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint64_t dk =
            gmma_desc(kt + (kk >> 2) * L::kBox + (kk & 3) * 32, 16, 1024);
        const uint64_t dq =
            gmma_desc(q_s + (kk >> 2) * L::kQBox + (kk & 3) * 32, 16, 1024);
        if (kk & 1)
          mma_ss<N>(sc2, dk, dq, kk > 1);
        else
          mma_ss<N>(sc, dk, dq, kk > 0);
      }
    }
    wgmma_commit();
  };
  // Once tile it's scores are done: its K stage released, the masks
  // (selects: nothing of a dead key's row reaches the result), and each
  // column's max over the warp's 16 keys into red[it & 1].
  auto finish_scores = [&](int it) {
    const int s = it % S;
    fence_regs(sc);
    fence_regs(sc2);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sc[i] += sc2[i];
    if constexpr (kInt8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ksc[h] = scales[s * 128 + key0 + 8 * h];
        vsc[h] = scales[s * 128 + kTmaKeys + key0 + 8 * h];
      }
    }
    release(k_empty(s));
    const int k0 = (first + it) * kTmaKeys;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kp = k0 + key0 + 8 * h;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sc[4 * j + 2 * h + c];
          if constexpr (kInt8) x *= ksc[h];
          const bool keep = kp <= q_hi[j][c] && kp > q_lo[j][c] &&
                            kp < a.t_len;
          sc[4 * j + 2 * h + c] = keep ? x : -CUDART_INF_F;
        }
    }
    float* r = red + (it & 1) * 4 * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float mx = fmaxf(sc[4 * j + c], sc[4 * j + 2 + c]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        if (g == 0) r[warp * N + 8 * j + 2 * t4 + c] = mx;
      }
  };
  // After the barrier: tile it's column maxima over the four warps, the
  // online softmax, p (int8: times v_scale, after l) into pc.
  auto softmax = [&](int it) {
    const float* r = red + (it & 1) * 4 * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 8 * j + 2 * t4 + c;
        const float mx = fmaxf(fmaxf(r[n], r[N + n]),
                               fmaxf(r[2 * N + n], r[3 * N + n]));
        // max(s) * scale is max(s * scale): rounding is monotone.  A
        // column that sees no key yet keeps m = NEG_BIG and p exactly 0.
        const float m_new = fmaxf(m_col[j][c], mx * a.sm_scale);
        const float m_l2 = fmaxf(m_new, SW_NEG_BIG / 2) * kLog2e;
        corr[j][c] = exp2f((m_col[j][c] - m_new) * kLog2e);
        m_col[j][c] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p = exp2f(fmaf(sc[4 * j + 2 * h + c], scale_l2, -m_l2));
          sum += p;
          if constexpr (kInt8)  // after l: l excludes the v scale
            p = p != 0.f ? p * vsc[h] : 0.f;
          pc[4 * j + 2 * h + c] = p;
        }
        l_col[j][c] = l_col[j][c] * corr[j][c] + sum;
      }
  };
  // Tile it's p^T in bf16 into buffer it & 1 (a K-major B: row n, key
  // column key0 (+ 8)); its V stage landed, bf16 rows of keys outside
  // [k_lo, k_end) zeroed (they may hold anything, and 0 * NaN is NaN; int8
  // rows are finite and their p is already 0).
  auto stage_p = [&](int it) {
    const uint32_t pb = p_s + (it & 1) * N * 128;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = 8 * j + 2 * t4 + c;
          const __nv_bfloat16 v = __float2bfloat16_rn(pc[4 * j + 2 * h + c]);
          asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(
                           pb + swz128(n, 2 * (key0 + 8 * h))),
                       "h"(*reinterpret_cast<const unsigned short*>(&v)));
        }
    const int s = it % S;
    mbar_wait(v_full(s), (it / S) & 1);
    if constexpr (!kInt8) {
      const int k0 = (first + it) * kTmaKeys;
      if (k0 < k_lo || k0 + kTmaKeys > k_end) {
        unsigned char* vb = sm + L::kOffV + s * L::kTile;
        constexpr int kRowChunks = D / 8;
        for (int i = tid; i < kTmaKeys * kRowChunks; i += 128) {
          const int r = i / kRowChunks;
          const int cc = i - r * kRowChunks;
          if (k0 + r < k_lo || k0 + r >= k_end)
            *reinterpret_cast<uint4*>(vb + (cc >> 3) * L::kBox + r * 128 +
                                      (cc & 7) * 16) =
                make_uint4(0, 0, 0, 0);
        }
      }
    }
    fence_proxy_async();
  };
  // acc rescaled by tile it's corr, then o^T += V^T p^T of tile it, the
  // k16 steps in key order.
  auto issue_pv = [&](int it) {
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mb][4 * j + e] *= corr[j][e & 1];
    const int s = it % S;
    const uint32_t pb = p_s + (it & 1) * N * 128;
    if constexpr (kInt8) {
      const unsigned char* vb = sm + L::kOffV + s * L::kTile;
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const int r = kq * 16 + 2 * t4;
        const int col = G * (8 * warp + g);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned char* at =
              vb + swz8<D>(r + (e & 1) + 8 * (e >> 1), col);
          if constexpr (G == 4)
            w[e] = *reinterpret_cast<const uint32_t*>(at);
          else
            w[e] = *reinterpret_cast<const uint16_t*>(at);
        }
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t jj = 2 * mb + h;
            const uint32_t sel = jj | ((4 + jj) << 8);
            va[kq][mb][h] = widen2(w[0], w[1], sel);
            va[kq][mb][2 + h] = widen2(w[2], w[3], sel);
          }
      }
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          mma_rs<N>(acc[mb], va[kq][mb], gmma_desc(pb + kq * 32, 16, 1024),
                    1);
    } else {
      const uint32_t vt = v_s + s * L::kTile;
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          mma_ts<N>(acc[mb],
                    gmma_desc(vt + mb * L::kBox + kq * 2048, L::kBox, 1024),
                    gmma_desc(pb + kq * 32, 16, 1024));
    }
    wgmma_commit();
  };

  if (n_items > 0) {
    issue_scores(0);
    wgmma_wait<0>();
    finish_scores(0);
    named_barrier(kBarId, 128);
    softmax(0);
    for (int it = 1; it < n_items; ++it) {
      issue_scores(it);
      stage_p(it - 1);
      wgmma_wait<0>();  // tile it's scores, and tile it - 2's p v
      finish_scores(it);
      if (it >= 2) release(v_empty((it - 2) % S));
      named_barrier(kBarId, 128);
      issue_pv(it - 1);
      softmax(it);
    }
    stage_p(n_items - 1);
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
    if (n_items >= 2) release(v_empty((n_items - 2) % S));
    named_barrier(kBarId, 128);
    issue_pv(n_items - 1);
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
    release(v_empty((n_items - 1) % S));
  }
  griddep_launch();

  // The columns' sums: over the warp's keys (a butterfly: every lane ends
  // with the same bits), then over the four warps in warp order.
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float l = l_col[j][c];
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      if (g == 0) red[warp * N + 8 * j + 2 * t4 + c] = l;
    }
  named_barrier(kBarId, 128);
  auto out_row = [&](int mb, int h) {
    return kInt8 ? G * (8 * warp + g) + 2 * mb + h : 64 * mb + key0 + 8 * h;
  };
  if (n_busy == 1) {  // the block has every live tile: the output
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 8 * j + 2 * t4 + c;
        if (n >= rows) continue;
        const float l = ((red[n] + red[N + n]) + red[2 * N + n]) +
                        red[3 * N + n];
        const float inv = 1.f / fmaxf(l, 1e-30f);
        bf16* ob = a.out + (static_cast<size_t>(bh) * rows + n) * D;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ob[out_row(mb, h)] =
                __float2bfloat16_rn(acc[mb][4 * j + 2 * h + c] * inv);
      }
    return;
  }

  // A partial, then the ticket.
  const size_t n_part = static_cast<size_t>(n_bh) * n_split * rows;
  const size_t part0 = (static_cast<size_t>(bh) * n_split + split) * rows;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = 8 * j + 2 * t4 + c;
      if (n >= rows) continue;
      float* ob = a.part + (part0 + n) * D;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ob[out_row(mb, h)] = acc[mb][4 * j + 2 * h + c];
      if (warp == 0 && g == 0) {
        a.part[n_part * D + part0 + n] = m_col[j][c];
        a.part[n_part * (D + 1) + part0 + n] =
            ((red[n] + red[N + n]) + red[2 * N + n]) + red[3 * N + n];
      }
    }
  // Up to kSingleMerge busy splits: the last block to take its ticket
  // merges them all.  More: the last block of each group of kMergeGroup
  // splits merges the group's (split order) into a group partial, and the
  // last of those merges the groups (group order), so that no one SM
  // reads every partial.
  unsigned int* tickets =
      g_tickets + (a.ticket_row * kTicketPairs + bh) * (1 + kGroups);
  const bool grouped = n_busy > kSingleMerge;
  const int group = split / kMergeGroup;
  const int n_groups = (n_busy + kMergeGroup - 1) / kMergeGroup;
  // The ticket: after the barrier every row of this block's partial is
  // written; the counter's acquire-release add publishes them (release,
  // cumulative over the barrier) and lets the last block see the others'
  // (acquire).
  auto last_in = [&](unsigned int* t, int count) {
    named_barrier(kBarId, 128);
    if (tid == 0) {
      unsigned int old;
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(t)
                   : "memory");
      const bool last = old == static_cast<unsigned>(count - 1);
      if (last) atomicExch(t, 0u);
      *flag = last;
    }
    named_barrier(kBarId, 128);
    return *flag != 0;
  };
  // The group partials: o [B * Hkv, G, R, D], then m and l [B * Hkv, G,
  // R], G = ceil(n_split / kMergeGroup), after the splits' partials.
  const int n_g = (n_split + kMergeGroup - 1) / kMergeGroup;
  const size_t n_grp = static_cast<size_t>(n_bh) * n_g * rows;
  float* grp = a.part + n_part * (D + 2);
  auto merge = [&](const float* o0, const float* m0, const float* l0,
                   int cnt, bf16* out, float* go, float* gm, float* gl) {
    if (rows * (D / 4) <= 128)
      merge_parts<D, N, 1>(o0, m0, l0, cnt, rows, sm, tid, out, go, gm, gl);
    else
      merge_parts<D, N, (N * D / 4 + 127) / 128>(o0, m0, l0, cnt, rows, sm,
                                                 tid, out, go, gm, gl);
  };
  bf16* out = a.out + static_cast<size_t>(bh) * rows * D;
  const size_t pbase = static_cast<size_t>(bh) * n_split * rows;
  if (!grouped) {
    if (!last_in(tickets, n_busy)) return;
    merge(a.part + pbase * D, a.part + n_part * D + pbase,
          a.part + n_part * (D + 1) + pbase, n_busy, out, nullptr, nullptr,
          nullptr);
    return;
  }
  const int z0 = group * kMergeGroup;
  if (!last_in(tickets + 1 + group,
               min(kMergeGroup, n_busy - z0)))
    return;
  const size_t gbase = (static_cast<size_t>(bh) * n_g + group) * rows;
  merge(a.part + (pbase + z0 * rows) * D,
        a.part + n_part * D + pbase + z0 * rows,
        a.part + n_part * (D + 1) + pbase + z0 * rows,
        min(kMergeGroup, n_busy - z0), nullptr, grp + gbase * D,
        grp + n_grp * D + gbase, grp + n_grp * (D + 1) + gbase);
  if (!last_in(tickets, n_groups)) return;
  const size_t g0 = static_cast<size_t>(bh) * n_g * rows;
  merge(grp + g0 * D, grp + n_grp * D + g0, grp + n_grp * (D + 1) + g0,
        n_groups, out, nullptr, nullptr, nullptr);
}

// The row of g_tickets that launches on ``st`` count on: one a stream, so
// that calls on two streams never share a counter (up to kTicketStreams
// streams a process; more share rows in turn).
int ticket_row(cudaStream_t st) {
  static std::mutex lock;
  static std::map<cudaStream_t, int> rows;
  std::lock_guard<std::mutex> guard(lock);
  auto hit = rows.find(st);
  if (hit != rows.end()) return hit->second;
  const int row = static_cast<int>(rows.size() % kTicketStreams);
  rows.emplace(st, row);
  return row;
}

template <typename TKV, int D, int N>
int launch_tma(const TmaArgs& a, const void* k, const void* v, int bh,
               int n_split, cudaStream_t st) {
  using L = TmaShape<TKV, D, N>;
  CUtensorMap km, vm;
  const bool ok = L::kInt8 ? int8_head_map(&km, k, bh, a.t_len, D) &&
                                 int8_head_map(&vm, v, bh, a.t_len, D)
                           : head_map(&km, k, bh, a.t_len, D) &&
                                 head_map(&vm, v, bh, a.t_len, D);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr auto kernel = decode_tma_kernel<TKV, D, N>;
  allow_smem_once<kernel>(L::kSmem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, bh);
  cfg.blockDim = dim3(kTmaThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, km, vm, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename TKV>
int run_tma(const TmaArgs& a, const void* k, const void* v, int bh, int d,
            int n_split, cudaStream_t st) {
  const bool wide = a.rows > 8;
  if (d == 128)
    return wide ? launch_tma<TKV, 128, 16>(a, k, v, bh, n_split, st)
                : launch_tma<TKV, 128, 8>(a, k, v, bh, n_split, st);
  if (d == 64)
    return wide ? launch_tma<TKV, 64, 16>(a, k, v, bh, n_split, st)
                : launch_tma<TKV, 64, 8>(a, k, v, bh, n_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory bytes one block needs (the wrapper checks the card's
// limit before launching): rows <= 16, d 64 or 128, 0 otherwise.
extern "C" size_t sw_decode_tma_smem(int rows, int d, int kv_int8) {
#define SW_TMA_SMEM(TKV, DD)                                  \
  if (d == DD)                                                \
    return rows > 8 ? TmaShape<TKV, DD, 16>::kSmem            \
                    : TmaShape<TKV, DD, 8>::kSmem;
  if (rows < 1 || rows > 16) return 0;
  if (kv_int8) {
    SW_TMA_SMEM(int8_t, 128)
    SW_TMA_SMEM(int8_t, 64)
  } else {
    SW_TMA_SMEM(__nv_bfloat16, 128)
    SW_TMA_SMEM(__nv_bfloat16, 64)
  }
#undef SW_TMA_SMEM
  return 0;
}

// bfloat16 q [B, Hq, C, D] and output, caches bf16 (kv_int8 0) or int8
// with float32 scales (1), every base 16-byte aligned.  pos: int32 device
// pointer read at b * pos_stride, or nullptr for pos_value at every row.
// rows = n_rep * C in 1 .. 16, d 64 or 128, window 0 for none.  n_split:
// blocks over T for each (batch row, kv head), 1 .. 256 (at most 1024
// such pairs above 1); part: float32 scratch of [B * Hkv, n_split + G,
// rows] x (d + 2), G = ceil(n_split / 8) where n_split > 8, else 0, where
// n_split > 1, else unused.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments it does not take
// or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int sw_decode_tma(const void* q, const void* k, const void* v,
                             const void* k_scale, const void* v_scale,
                             const void* pos, int pos_stride, int pos_value,
                             void* out, void* part, int b, int hkv, int rows,
                             int n_q, int t_len, int d, int window,
                             float sm_scale, int kv_int8, int n_split,
                             void* stream) {
  const int bh = b * hkv;
  if (rows < 1 || rows > 16 || n_split < 1 || n_split > kMaxTmaSplits ||
      bh < 1 || bh > 65535 || t_len < 1 ||
      (n_split > 1 && (bh > kTicketPairs || part == nullptr)) ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TmaArgs a{static_cast<const bf16*>(q),
                  static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale),
                  static_cast<const int*>(pos),
                  pos_stride,
                  pos_value,
                  static_cast<bf16*>(out),
                  static_cast<float*>(part),
                  n_split > 1 ? ticket_row(st) : 0,
                  hkv,
                  rows,
                  n_q,
                  t_len,
                  window,
                  sm_scale};
  if (kv_int8) return run_tma<int8_t>(a, k, v, bh, d, n_split, st);
  return run_tma<__nv_bfloat16>(a, k, v, bh, d, n_split, st);
}
