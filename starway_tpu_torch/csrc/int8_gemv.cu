// W8A16 matmul: out [M, F] = (x [M, D] @ wq int8 [D, F]) * scale f32 [F].
//
// Replaces the TPU kernel starway_tpu/ops/pallas_gemv.py _gemv_kernel
// (entry int8_matmul).
//
// What bounds it: at decode (M = the serving step's rows, a few to a few
// dozen) the int8 weight stream, one byte per parameter per step; at
// prefill (M = the prompt bucket, up to max_len) the multiply-adds.  Every
// int8 value is exact in bf16, so bf16 x times the widened weight on the
// tensor cores (mma.sync.m16n8k16, float32 accumulators) is the TPU
// kernel's algebra; the per-column scale is applied once, after the
// product, and no wide weight tile exists in device memory.  Unlike the TPU
// kernel, which keeps all of x resident, both regimes tile M and F and mask
// the ragged edges of M, D and F (the lm_head has F = 128256).  Three
// kernels, chosen by ops/gemv.py gemv_plan, a function of the shapes:
//
// * Decode regime (bf16, M <= 32): gemv_decode_kernel.  The weight is the
//   m16 operand and x's rows the n8 operand, so M = 8 fills one n-tile.  A
//   thread loads 16 bytes of each of 4 weight rows per k16 step (four
//   steps in flight at M <= 8, 256 bytes a thread) straight into registers
//   and widens them to bf16 A fragments there: the 4 rows are the thread's
//   4 k values of the fragment and its 16 columns 8 m-tiles, and x's 4
//   matching values are one 8-byte load.  A block of 4 warps covers 128
//   columns and one chunk of D (the split, blockIdx.y), the warps
//   interleaving its k16 steps; their sums meet in shared memory in a
//   fixed order.  The split brings the path's shapes to about two blocks
//   an SM; the splits of a column tile (up to 16) are one thread block
//   cluster whose blocks add up each other's sums over distributed shared
//   memory, in split order.  At M <= 8, and for grids of one block an SM,
//   the kernel is a programmatic dependent launch (EARLY): its blocks may
//   start while the kernel ahead finishes and load their first weight
//   round (read-only) before griddepcontrol.wait, so a GEMV's launch and
//   first loads hide behind the one before it (k behind q, v behind k).
// * Prefill regime (bf16, M > 32): on Hopper's wgmma fed by TMA in
//   csrc/w8a16_wgmma.cu wherever TMA takes the operands (D % 8 == 0, F %
//   16 == 0, 16-byte aligned bases: ops/gemv.py prefill_route), every
//   projection of the serving paths; here, for the rest,
//   gemv_prefill_kernel, a BM x BN x 64
//   block tile (BM 64 or 128, BN 256, or 128 on small grids) on warps of
//   (BM / 2) x 64.  x and the
//   int8 weight tile enter by 16-byte cp.async into a 4-stage ring; x
//   feeds the A operand by ldmatrix, and each warp widens its B fragments
//   from the int8 tile in registers (the same k-ordering trick as decode),
//   so no bf16 copy of the weight exists even in shared memory.  The wide
//   F tile (one byte a weight) cuts the L2 bytes a multiply-add costs by a
//   third against 128 x 128, where the grid has the blocks for it.  Where the grid is under one block an SM, D
//   is split (up to 8 ways), and the splits add up as at decode.
// * float32 x (the parity runs): int8_matmul_fma_kernel, the first
//   version, on the FMA units: 8 x 32 or 64 x 64 tiles, the weight widened
//   to float32 in shared memory.
//
// Splits need no workspace in device memory, no second kernel and no
// atomics: two calls give identical bits.
#include <cooperative_groups.h>

#include "common.cuh"
#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The two halves of a cluster barrier; the arrive is relaxed, so the pair
// orders no memory, only that every block of the cluster has started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Programmatic dependent launch: a grid launched with the attribute may
// start before the kernel ahead of it in the stream has finished;
// griddep_wait() returns once that kernel has completed and its writes are
// visible, and griddep_launch() lets the next such grid start.  Without
// the attribute both are no-ops.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ------------------------------------------------------- decode regime

constexpr int kCols = 128;       // F columns a block (both regimes)
constexpr int kDecThreads = 128;  // 4 warps
constexpr int kDecRows = 64;     // rows of D a round of the 4 warps

constexpr int kDecMaxSplits = 16;  // a non-portable cluster

// Four warps' sums, then the slots of the splits' sums a block owns
// (splits x ceil(tile / splits) float4, at most a tile and a float4 a
// split more).
template <int NT>
constexpr size_t decode_smem() {
  return sizeof(float) * 5 * 8 * NT * kCols + 16 * kDecMaxSplits;
}

// Weight rows rr .. rr + 3, columns fc .. fc + 15 (zero past r_end or f).
template <bool VEC>
__device__ __forceinline__ void load_w4(uint4 (&v)[4], const int8_t* w,
                                        int rr, int r_end, int f, int fc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = rr + j;
    if (VEC) {
      v[j] = row < r_end && fc < f
                 ? __ldg(reinterpret_cast<const uint4*>(
                       w + static_cast<size_t>(row) * f + fc))
                 : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t b[4] = {0, 0, 0, 0};
      if (row < r_end) {
        const int8_t* src = w + static_cast<size_t>(row) * f;
#pragma unroll
        for (int q = 0; q < 16; ++q)
          if (fc + q < f)
            b[q >> 2] |= static_cast<uint32_t>(
                             static_cast<uint8_t>(src[fc + q]))
                         << (8 * (q & 3));
      }
      v[j] = make_uint4(b[0], b[1], b[2], b[3]);
    }
  }
}

// x[n][rr .. rr + 3] as two bf16x2 (zero past m or r_end).
template <bool VEC>
__device__ __forceinline__ uint2 load_x4(const bf16* x, int n, int rr,
                                         int r_end, int m, int d) {
  if (n >= m) return make_uint2(0, 0);
  const bf16* src = x + static_cast<size_t>(n) * d + rr;
  if (VEC)
    return rr < r_end ? *reinterpret_cast<const uint2*>(src)
                      : make_uint2(0, 0);
  uint16_t e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    e[j] = rr + j < r_end ? reinterpret_cast<const uint16_t*>(src)[j] : 0;
  return make_uint2(e[0] | (static_cast<uint32_t>(e[1]) << 16),
                    e[2] | (static_cast<uint32_t>(e[3]) << 16));
}

// Grid (ceil(F / 128), splits); split z sums rows [z chunk, (z + 1) chunk)
// (chunk a multiple of 16) and the splits of a column tile are one
// cluster.  NT n8 tiles of x rows
// (M <= 8 NT).  VEC: F % 16 == 0, wq 16-byte aligned, D % 4 == 0 and x
// 8-byte aligned.  EARLY: launched as a programmatic dependent launch
// (see griddep_wait; ops/gemv.py early_launch says when).
template <int NT, bool VEC, bool EARLY>
__global__ void __launch_bounds__(kDecThreads) gemv_decode_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, bf16* __restrict__ out, int m, int d,
    int f, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);  // [4][8 NT][kCols]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int fb = blockIdx.x * kCols;
  const int fc = fb + 16 * g;  // this quad's 16 columns: A rows g, g + 8
  const int r_begin = blockIdx.y * chunk;
  const int r_end = min(r_begin + chunk, d);
  if (gridDim.y > 1) cluster_arrive();  // this block has started

  // acc[i][nt]: m-tile i holds columns fc + 2 i (rows g) and fc + 2 i + 1
  // (rows g + 8); n-tile nt holds x rows nt * 8 + 2 t4 and + 1.
  float acc[8][NT][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  // Each k16 step: this thread's k values 2 t4, 2 t4 + 1, 2 t4 + 8,
  // 2 t4 + 9 are rows rr .. rr + 3, rr = step + 4 t4, in A and in B alike.
  // EARLY (a programmatic dependent launch): the weight is read-only, so
  // its first round streams in before griddep_wait(); x, the scale and
  // the output are touched only after it.
  constexpr int U = NT == 1 ? 4 : 2;  // k16 steps a thread has in flight
  const int r_first = r_begin + warp * 16;
  for (int r0 = r_first; r0 < r_end; r0 += U * kDecRows) {
    uint4 wv[U][4];
    uint2 xv[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r0 + u * kDecRows + 4 * t4;
      load_w4<VEC>(wv[u], w, rr, r_end, f, fc);
      if (!EARLY) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          xv[u][nt] = load_x4<VEC>(x, nt * 8 + g, rr, r_end, m, d);
      }
    }
    if (EARLY) {
      if (r0 == r_first) {
        griddep_wait();
        griddep_launch();
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          xv[u][nt] = load_x4<VEC>(x, nt * 8 + g,
                                   r0 + u * kDecRows + 4 * t4, r_end, m, d);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r0 + u * kDecRows >= r_end) break;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = i >> 1;
        const uint32_t p = (2 * i) & 3;  // byte of column fc + 2 i
        const uint32_t s0 = p | ((p + 4) << 8);
        const uint32_t s1 = (p + 1) | ((p + 5) << 8);
        uint32_t a[4];
        a[0] = widen2(word(wv[u][0], q), word(wv[u][1], q), s0);
        a[1] = widen2(word(wv[u][0], q), word(wv[u][1], q), s1);
        a[2] = widen2(word(wv[u][2], q), word(wv[u][3], q), s0);
        a[3] = widen2(word(wv[u][2], q), word(wv[u][3], q), s1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma(acc[i][nt], a, xv[u][nt].x, xv[u][nt].y);
      }
    }
  }
  if (EARLY) griddep_wait();  // also a warp that had no rows, before writing

  constexpr int MP = 8 * NT;  // x rows padded to the n-tiles
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t4;
      float* r = red + (warp * MP + n) * kCols + 16 * g + 2 * i;
      r[0] = acc[i][nt][0];
      r[1] = acc[i][nt][2];
      r[kCols] = acc[i][nt][1];
      r[kCols + 1] = acc[i][nt][3];
    }
  __syncthreads();
  if (gridDim.y == 1) {
    for (int idx = threadIdx.x; idx < MP * kCols; idx += kDecThreads) {
      const int n = idx / kCols;
      const int gf = fb + idx - n * kCols;
      if (n >= m || gf >= f) continue;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += red[k * MP * kCols + idx];
      out[static_cast<size_t>(n) * f + gf] = __float2bfloat16_rn(s * scale[gf]);
    }
    return;
  }

  // Block z of the cluster owns float4 [z per, (z + 1) per) of the tile's
  // sums: every block stores its sums of them into the owner's slot for
  // its split (slots [splits][per] after the warps' sums), and after the
  // cluster's barrier each owner adds up its slots in split order.
  constexpr int N4 = MP * kCols / 4;
  const int splits = static_cast<int>(gridDim.y);
  const int rank = static_cast<int>(blockIdx.y);
  const int per = (N4 + splits - 1) / splits;
  float4* slots = reinterpret_cast<float4*>(red + 4 * MP * kCols);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();  // every block of the cluster has started
  for (int i4 = threadIdx.x; i4 < N4; i4 += kDecThreads) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 v =
          reinterpret_cast<const float4*>(red + k * MP * kCols)[i4];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int owner = i4 / per;
    *cluster.map_shared_rank(slots + rank * per + i4 - owner * per, owner) = s;
  }
  cluster.sync();  // the slots are full; no block reads another's after
  for (int j = threadIdx.x; j < per && rank * per + j < N4; j += kDecThreads) {
    float4 s = slots[j];
    for (int z = 1; z < splits; ++z) {
      const float4 v = slots[z * per + j];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int i4 = rank * per + j;
    const int n = 4 * i4 / kCols;
    const int col = fb + 4 * i4 - n * kCols;
    if (n < m) {
      const float e[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < f)
          out[static_cast<size_t>(n) * f + col + c] =
              __float2bfloat16_rn(e[c] * scale[col + c]);
    }
  }
}

// ------------------------------------------------------ prefill regime

constexpr int kBK = 64;           // rows of D a stage (and a split's unit)
constexpr int kXLd = kBK + 8;     // bf16 row stride of the x tile
constexpr int kStages = 4;
constexpr int kMaxSplits = 8;     // a portable cluster of 139 KB blocks

// The pipeline's ring; a split's float32 sums (rows padded by 4), which the
// cluster reads, take its memory over after the last stage.
template <int BM, int BN>
constexpr size_t prefill_smem() {
  const size_t ring = kStages * (sizeof(bf16) * BM * kXLd + kBK * BN);
  const size_t sums = sizeof(float) * BM * (BN + 4);
  return ring > sums ? ring : sums;
}

// Byte of (row, col) in a [kBK][BN] int8 tile whose 16-byte chunks are
// swizzled by row: chunk ^ 2 ((row >> 1) & 3), so a warp's 8-byte reads
// of rows 2 t4 + {0, 1, 8, 9} fall on distinct banks.
template <int BN>
__device__ __forceinline__ int w8_at(int row, int col) {
  return row * BN + (((col >> 4) ^ (((row >> 1) & 3) << 1)) << 4) +
         (col & 15);
}

// Grid (ceil(F / BN), ceil(M / BM), splits); split z sums rows
// [z chunk, (z + 1) chunk) of D (chunk a multiple of kBK).  BN (128 or
// 256) threads, 2 x BN / 64 warps of (BM / 2) rows x 64 columns.  A (x) comes by ldmatrix; B (the weight) is
// widened in registers from 8-byte reads of the int8 tile: the thread's k
// values 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 are 4 rows of it, and n-tile j
// of the warp takes column 8 g + j, so one read covers all 8 n-tiles.
// With splits > 1 the grid's splits of one tile are one thread block
// cluster: each block leaves its float32 sums in its shared memory, and
// block z adds up rows [z, z + 1) * ceil(BM / splits) of all of them, in
// split order, over distributed shared memory.
// VEC: F % 16 == 0, D % 8 == 0 and x, wq 16-byte aligned (16-byte
// cp.async); else element loads.
template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(BN) gemv_prefill_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, bf16* __restrict__ out, int m, int d,
    int f, int chunk) {
  constexpr int MT = BM / 32;  // m16 tiles a warp
  constexpr int NTH = BN;  // 2 x BN / 64 warps
  constexpr int XT = BM * kXLd;
  constexpr int WT = kBK * BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kStages][BM][kXLd]
  int8_t* w8 = reinterpret_cast<int8_t*>(xs + kStages * XT);  // [S][WT]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = warp / (BN / 64);
  const int wn = warp % (BN / 64);
  const int f0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(k_begin + chunk, d);
  const int nk = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load = [&](int kt, int stage) {
    const int k0 = k_begin + kt * kBK;
    bf16* xd = xs + stage * XT;
    for (int c = tid; c < BM * (kBK / 8); c += NTH) {
      const int r = c / (kBK / 8);
      const int col = (c - r * (kBK / 8)) * 8;
      const int gm = m0 + r;
      if (VEC) {
        const bool ok = gm < m && k0 + col < k_end;
        cp_async16(smem_u32(xd + r * kXLd + col),
                   ok ? x + static_cast<size_t>(gm) * d + k0 + col : x,
                   ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = k0 + col + e;
          xd[r * kXLd + col + e] = gm < m && k < k_end
                                       ? x[static_cast<size_t>(gm) * d + k]
                                       : __float2bfloat16_rn(0.f);
        }
      }
    }
    int8_t* wd = w8 + stage * WT;
    for (int c = tid; c < WT / 16; c += NTH) {
      const int r = c / (BN / 16);
      const int col = (c - r * (BN / 16)) * 16;
      const int gk = k0 + r;
      if (VEC) {
        const bool ok = gk < k_end && f0 + col < f;
        cp_async16(smem_u32(wd + w8_at<BN>(r, col)),
                   ok ? w + static_cast<size_t>(gk) * f + f0 + col : w,
                   ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int gf = f0 + col + e;
          wd[w8_at<BN>(r, col) + e] =
              gk < k_end && gf < f ? w[static_cast<size_t>(gk) * f + gf] : 0;
        }
      }
    }
  };

  float acc[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  const int a_row = wm * (BM / 2) + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_col = wn * 64 + 8 * g;
  for (int kt = 0; kt < nk; ++kt) {
    // Tile kt has landed; every warp is done with tile kt - 1, whose
    // stage the next copy refills.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk)
      load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* xa = xs + (kt % kStages) * XT;
    const int8_t* wt = w8 + (kt % kStages) * WT;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], smem_u32(xa + (a_row + i * 16) * kXLd + kk * 16 +
                               a_col));
      uint2 r[4];  // rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = *reinterpret_cast<const uint2*>(
            wt + w8_at<BN>(kk * 16 + 2 * t4 + (q & 1) + (q >> 1) * 8, b_col));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t p = j & 3;
        const uint32_t sel = p | ((p + 4) << 8);
        const uint32_t b0 = widen2(j < 4 ? r[0].x : r[0].y,
                                   j < 4 ? r[1].x : r[1].y, sel);
        const uint32_t b1 = widen2(j < 4 ? r[2].x : r[2].y,
                                   j < 4 ? r[3].x : r[3].y, sel);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma(acc[i][j], a[i], b0, b1);
      }
    }
  }

  // Thread (g, t4) holds, for each of its rows, the tile's columns
  // wn * 64 + 16 t4 + c: acc[.][c][2 h] for c < 8, acc[.][c - 8][2 h + 1]
  // above.
  const int lcol = wn * 64 + 16 * t4;
  if (gridDim.z == 1) {
    const int col0 = f0 + lcol;
    float sc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) sc[c] = col0 + c < f ? scale[col0 + c] : 0.f;
    const bool whole = col0 + 16 <= f && f % 8 == 0;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * (BM / 2) + i * 16 + g + h * 8;
        if (row >= m) continue;
        float v[16];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          v[c] = acc[i][c][2 * h] * sc[c];
          v[c + 8] = acc[i][c][2 * h + 1] * sc[c + 8];
        }
        bf16* o = out + static_cast<size_t>(row) * f + col0;
        if (whole) {
          uint32_t pk[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) pk[c] = pack_bf16(v[2 * c], v[2 * c + 1]);
          reinterpret_cast<uint4*>(o)[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
          reinterpret_cast<uint4*>(o)[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
        } else {
#pragma unroll
          for (int c = 0; c < 16; ++c)
            if (col0 + c < f) o[c] = __float2bfloat16_rn(v[c]);
        }
      }
    return;
  }

  constexpr int SLD = BN + 4;  // float row stride of the sums
  cg::cluster_group cluster = cg::this_cluster();
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the sums take its place
  float* sums = reinterpret_cast<float*>(smem_raw);  // [BM][SLD]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4* dst = reinterpret_cast<float4*>(
          sums + (wm * (BM / 2) + i * 16 + g + h * 8) * SLD + lcol);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // columns 4 q .. 4 q + 3 of the 16
        const int e = 2 * h + (q >> 1);
        const int c = 4 * (q & 1);
        dst[q] = make_float4(acc[i][c][e], acc[i][c + 1][e], acc[i][c + 2][e],
                             acc[i][c + 3][e]);
      }
    }
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (BM + splits - 1) / splits;
  const int r_lo = rank * per;
  const int r_hi = min(BM, r_lo + per);
  for (int idx = tid; idx < (r_hi - r_lo) * (BN / 4);
       idx += NTH) {
    const int lr = r_lo + idx / (BN / 4);
    const int c4 = (idx % (BN / 4)) * 4;
    float4 v[kMaxSplits];  // every split's read in flight, then the sum
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < splits)
        v[z] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(sums + lr * SLD + c4, z));
    float4 s = v[0];
#pragma unroll
    for (int z = 1; z < kMaxSplits; ++z)
      if (z < splits) {
        s.x += v[z].x;
        s.y += v[z].y;
        s.z += v[z].z;
        s.w += v[z].w;
      }
    const int row = m0 + lr;
    const int col = f0 + c4;
    if (row >= m) continue;
    const float e[4] = {s.x, s.y, s.z, s.w};
    bf16* o = out + static_cast<size_t>(row) * f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < f) o[col + c] = __float2bfloat16_rn(e[c] * scale[col + c]);
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// ---------------------------------------------------- float32, FMA units

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) int8_matmul_fma_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out, int m, int d,
    int f, int vec) {
  constexpr int NX = BN / TN;  // threads along F
  constexpr int NT = (BM / TM) * NX;
  constexpr int VPR = BN / 16;  // 16-byte weight vectors per tile row
  constexpr int NV = BK * VPR;
  constexpr int VITERS = (NV + NT - 1) / NT;
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % NX;
  const int ty = tid / NX;
  const int m0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    if (vec) {
      uint4 buf[VITERS];
#pragma unroll
      for (int it = 0; it < VITERS; ++it) {
        const int c = tid + it * NT;
        const int kk = c / VPR;
        const int gk = k0 + kk, gf = f0 + (c - kk * VPR) * 16;
        buf[it] = make_uint4(0, 0, 0, 0);
        if (c < NV && gk < d && gf < f)
          buf[it] = *reinterpret_cast<const uint4*>(
              w + static_cast<size_t>(gk) * f + gf);
      }
#pragma unroll
      for (int it = 0; it < VITERS; ++it) {
        const int c = tid + it * NT;
        if (c >= NV) break;
        const int kk = c / VPR;
        const int n = (c - kk * VPR) * 16;
        const int8_t* e = reinterpret_cast<const int8_t*>(&buf[it]);
#pragma unroll
        for (int q = 0; q < 16; ++q) ws[kk][n + q] = static_cast<float>(e[q]);
      }
    } else {
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = i / BN;
        const int n = i - kk * BN;
        const int gk = k0 + kk, gf = f0 + n;
        ws[kk][n] = gk < d && gf < f
                        ? static_cast<float>(
                              w[static_cast<size_t>(gk) * f + gf])
                        : 0.f;
      }
    }
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK;
      const int kk = i - r * BK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = gm < m && gk < d
                      ? sw_to_float(x[static_cast<size_t>(gm) * d + gk])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bw[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bw[j] = ws[kk][tx + j * NX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gf = f0 + tx + j * NX;
      if (gf < f)
        out[static_cast<size_t>(gm) * f + gf] =
            sw_from_float<T>(acc[i][j] * scale[gf]);
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
int launch_fma(const void* x, const void* w, const void* scale, void* out,
               int m, int d, int f, int vec, cudaStream_t stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM);
  int8_matmul_fma_kernel<float, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const float*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(scale), static_cast<float*>(out), m, d,
          f, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- launch

struct Args {
  const bf16* x;
  const int8_t* w;
  const float* scale;
  bf16* out;
  int m, d, f, splits, chunk;
  cudaStream_t stream;
};

// Launch ``kernel`` with the grid's splits (grid axis ``axis``: 1 = y,
// 2 = z) as one thread block cluster each; ``early``: as a programmatic
// dependent launch (see griddep_wait).
template <typename K>
int launch_split(K kernel, dim3 grid, int threads, size_t smem, int axis,
                 bool early, const Args& a) {
  sw_allow_smem(kernel, smem);
  if (a.splits > 8)
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = axis == 1 ? a.splits : 1;
  attr[0].val.clusterDim.z = axis == 2 ? a.splits : 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = early ? 2 : 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a.x, a.w, a.scale,
                                             a.out, a.m, a.d, a.f, a.chunk));
}

template <int NT, bool VEC, bool EARLY>
int launch_decode(const Args& a) {
  return launch_split(gemv_decode_kernel<NT, VEC, EARLY>,
                      dim3((a.f + kCols - 1) / kCols, a.splits), kDecThreads,
                      decode_smem<NT>(), 1, EARLY, a);
}

template <bool VEC, bool EARLY>
int decode(const Args& a) {
  if (a.m <= 8) return launch_decode<1, VEC, EARLY>(a);
  if (a.m <= 16) return launch_decode<2, VEC, EARLY>(a);
  if (a.m <= 32) return launch_decode<4, VEC, EARLY>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool EARLY>
int decode(const Args& a, int vec) {
  return vec ? decode<true, EARLY>(a) : decode<false, EARLY>(a);
}

template <int BM, int BN, bool VEC>
int launch_prefill(const Args& a) {
  return launch_split(
      gemv_prefill_kernel<BM, BN, VEC>,
      dim3((a.f + BN - 1) / BN, (a.m + BM - 1) / BM, a.splits), BN,
      prefill_smem<BM, BN>(), 2, false, a);
}

template <int BM, int BN>
int prefill(const Args& a, int vec) {
  return vec ? launch_prefill<BM, BN, true>(a)
             : launch_prefill<BM, BN, false>(a);
}

}  // namespace

// x [M, D] (bfloat16 if is_bf16 else float32), wq int8 [D, F], scale
// float32 [F], out [M, F] in x's dtype.  regime: 0 float32 on the FMA
// units (vec: F % 16 == 0 and wq 16-byte aligned); 1 decode (bf16, M <=
// 32), 3 the same as a programmatic dependent launch (EARLY), 2 prefill
// (bf16, tile_m 64 or 128 rows and tile_n 128 or 256 columns a block).
// vec for regimes 1-3: every 16-byte (decode: x's 8-byte) load is
// aligned, see the kernels.  splits: chunks of D of ``chunk`` rows
// (splits * chunk >= D; chunk a multiple of 16 at decode and of 64 at
// prefill), at most 16 at decode and 8 at prefill: the splits of an
// output tile are one cluster.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments out of range).
extern "C" int sw_int8_matmul(const void* x, const void* wq,
                              const void* scale, void* out, int m, int d,
                              int f, int is_bf16, int vec, int regime,
                              int tile_m, int tile_n, int splits, int chunk,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (regime == 0) {
    if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    if (m <= 8)
      return launch_fma<8, 32, 128, 1, 2>(x, wq, scale, out, m, d, f, vec, st);
    return launch_fma<64, 64, 32, 4, 4>(x, wq, scale, out, m, d, f, vec, st);
  }
  const bool decoding = regime == 1 || regime == 3;
  const int unit = decoding ? 16 : kBK;  // a k16 step, a stage
  if (!is_bf16 || splits < 1 || chunk < unit || chunk % unit ||
      (regime == 2 && tile_m != 64 && tile_m != 128) ||
      static_cast<long long>(splits) * chunk < d ||
      splits > (decoding ? kDecMaxSplits : kMaxSplits))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
               static_cast<const float*>(scale), static_cast<bf16*>(out), m,
               d, f, splits, chunk, st};
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (regime == 1)
    err = decode<false>(a, vec);
  else if (regime == 3)
    err = decode<true>(a, vec);
  else if (regime == 2 && tile_n == 256)
    err = tile_m == 64 ? prefill<64, 256>(a, vec) : prefill<128, 256>(a, vec);
  else if (regime == 2 && tile_n == 128)
    err = tile_m == 64 ? prefill<64, 128>(a, vec) : prefill<128, 128>(a, vec);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
