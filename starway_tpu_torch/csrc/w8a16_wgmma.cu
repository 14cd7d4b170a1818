// W8A16 matmul, prefill regime, on Hopper's own tensor cores and copies:
// out [M, F] = (x [M, D] bf16 @ wq int8 [D, F]) * scale f32 [F], the sums
// float32 and the per-column scale applied once, after the product.
//
// Replaces the TPU kernel starway_tpu/ops/pallas_gemv.py _gemv_kernel (:32)
// where ops/gemv.py routes the prefill regime here: bf16 x, M above
// DECODE_MAX_M, D % 8 == 0, F % 16 == 0 and every base 16-byte aligned
// (TMA's terms).  The decode regime and the shapes TMA refuses stay on
// csrc/int8_gemv.cu's kernels.
//
// What bounds it: operations (2 M D F flops against D F + 2 M (D + F)
// bytes; at M = 512 about 1000 flops a byte).  mma.sync, Ampere's
// instruction, runs on Hopper at well under its full rate; wgmma is the way
// to it.  Every int8 value is exact in bf16, so bf16 x times the widened
// weight is the TPU kernel's algebra.
//
// Where the weight is widened (the design's choice).  wgmma reads B only
// from shared memory and A from shared memory or registers, and int8 is no
// operand of a bf16 product.  (a) Widening the int8 tile into a swizzled
// bf16 tile in shared memory for an MN-major B costs a second pass over
// shared memory a stage, a barrier between the warpgroups that write it
// and the products that read it, and a proxy fence.  (b), taken here,
// computes out^T = wq^T x^T: the weight is wgmma's A operand in registers,
// widened there from the int8 tile the TMA brought in, and x is a K-major
// B from shared memory as it lies in device memory.  The rows of the
// product (F) may be numbered freely, so thread (warp w, lane g, t4) takes
// the 4 adjacent columns 4 (8 w + g) .. + 3 of its warpgroup's 128 as its
// rows g and g + 8 of m64 tiles 0 and 1: one 32-bit shared-memory read of
// each of its 4 k rows (2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9) gives all 16
// int8 values of both A fragments of a k16 step, and 8 byte permutes with
// the exact int8 -> bf16 trick (ptx.cuh widen2) make the K-adjacent pairs.
// The TMA's 128-byte swizzle spreads those reads over all 32 banks: a warp
// reads 8 chunks of 16 bytes, chunk 2 w + g / 4 of rows 2 t4 + c, and the
// swizzle XORs the chunk with the row's 2 t4 + c, so the 4 rows land on
// distinct chunk pairs.  No bank conflicts and no shuffles; the cost is 4
// loads and 8 permute-and-subtract widenings a thread per k16 step, for 2
// wgmma.m64n{BM}k16, on the CUDA cores beside the tensor cores.
//
// A block: one producer warpgroup (setmaxnreg.dec to 40) whose one thread
// keeps a kStages ring of [64 D rows] stages full by TMA (x as a box of BM
// rows x 64 columns, the weight as two boxes of 64 rows x 128 columns;
// rows and columns past M, D or F arrive as zeros), and two consumer
// warpgroups (setmaxnreg.inc to 232), each 128 columns of F x BM rows of M
// (BM 64 or 128), so a block is 256 x BM of the output.  A consumer
// widens stage kt + 1's A fragments (into a second set of registers) while
// stage kt's 8 products run, then frees stage kt; the two consumers' work
// interleaves as well.  The copies bound it next: streaming the stages
// alone (no products) takes about half the kernel's time at M = 512.
//
// Grid shape.  At M = 512, F = 14336 the grid is 56 x 4 = 224 blocks of
// one an SM (two waves over 132 SMs); a persistent schedule would walk the
// same 224 tiles in the same two waves, so it buys nothing here.  Where the
// grid is under a wave, D is split (ops/gemv.py wgmma_plan: up to 8 ways,
// the grid within one wave) and the splits of a tile are one thread block
// cluster: each block leaves its float32 sums in its shared memory and
// block z adds up its share of the tile's rows of all of them, in split
// order, over distributed shared memory.  No workspace, no atomics: two
// calls give identical bits.  Registers: see PERF.md's kernel table
// (ptxas -v for sm_90a, chip_smoke.py's report, "gemv prefill wgmma").
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kBK = 64;          // rows of D a stage (and a split's unit)
constexpr int kBF = 256;         // columns of F a block, 128 a consumer
constexpr int kStages = 4;
constexpr int kMaxSplits = 8;    // a portable cluster
constexpr int kSLD = kBF + 4;    // float row stride of a split's sums
constexpr int kWBytes = kBK * kBF;  // the int8 tile of a stage: 2 boxes

template <int BM>
struct GemmLayout {
  static constexpr int kXBytes = BM * kBK * 2;
  static constexpr size_t kRing =
      static_cast<size_t>(kStages) * (kXBytes + kWBytes);
  static constexpr size_t kSums = sizeof(float) * BM * kSLD;
  static constexpr size_t kBody = kRing > kSums ? kRing : kSums;
  static constexpr size_t kSmem = 1024 + kBody + 16 * kStages;
};

// The byte selector of widen2 for byte p of both words.
__device__ __forceinline__ uint32_t sel(uint32_t p) {
  return p | ((p + 4) << 8);
}

// Grid (ceil(F / 256), ceil(M / BM), splits); split z sums rows [z chunk,
// (z + 1) chunk) of D (chunk a multiple of kBK), and the splits of a tile
// are one cluster.  384 threads: the producer warpgroup, then the two
// consumers.
template <int BM>
__global__ void __launch_bounds__(384, 1) w8a16_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map,
    const __grid_constant__ CUtensorMap w_map,
    const float* __restrict__ scale, bf16* __restrict__ out, int m, int d,
    int f, int chunk) {
  using L = GemmLayout<BM>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t x_s = smem_u32(sm);                // [kStages][BM][64]
  const uint32_t w_s = x_s + kStages * L::kXBytes;  // [kStages][2][64][128]
  const uint32_t bar = x_s + L::kBody;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };

  const int f0 = blockIdx.x * kBF;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(k_begin + chunk, d);
  const int nk = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const bool split = gridDim.z > 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {  // ------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      // A second box wholly past F is not loaded: its consumer's columns
      // are never written.
      const bool both = f0 + 128 < f;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(s), ((kt / kStages) - 1) & 1);
        const int k0 = k_begin + kt * kBK;
        mbar_expect_tx(full(s), L::kXBytes + (both ? 2 : 1) * kWBytes / 2);
        tma_load_2d(x_s + s * L::kXBytes, &x_map, full(s), k0, m0);
        tma_load_2d(w_s + s * kWBytes, &w_map, full(s), f0, k0);
        if (both)
          tma_load_2d(w_s + s * kWBytes + kWBytes / 2, &w_map, full(s),
                      f0 + 128, k0);
      }
    }
    __syncwarp();
    if (split) {  // the consumers' two cluster barriers
      cluster_sync_all();
      cluster_sync_all();
    }
    return;
  }

  // ------------------------------------------------------------ consumer
  setmaxnreg_inc<232>();
  const int c = wg - 1;  // columns 128 c .. 128 c + 127 of the block
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int fb = 4 * (8 * warp + g);  // this thread's 4 columns of the 128
  const int chk = fb >> 4;            // their 16-byte chunk of a box row
  const int inb = fb & 15;

  // acc[i]: m64 tile i of out^T, N = BM rows of x; thread rows g and g + 8
  // of tile i are columns fb + 2 i and fb + 2 i + 1.
  float acc[2][BM / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < BM / 2; ++e) acc[i][e] = 0.f;

  // Stage kt's A fragments: [k16 step][m64 tile][fragment].
  using Frags = uint32_t[4][2][4];
  auto widen = [&](int kt, Frags& a) {
    const int s = kt % kStages;
    mbar_wait(full(s), (kt / kStages) & 1);
    const unsigned char* wt = sm + kStages * L::kXBytes + s * kWBytes +
                              c * (kWBytes / 2);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t r[4];  // rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = kk * 16 + 2 * t4 + (q & 1) + (q >> 1) * 8;
        r[q] = *reinterpret_cast<const uint32_t*>(
            wt + row * 128 + ((chk ^ (row & 7)) << 4) + inb);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[kk][i][0] = widen2(r[0], r[1], sel(2 * i));
        a[kk][i][1] = widen2(r[0], r[1], sel(2 * i + 1));
        a[kk][i][2] = widen2(r[2], r[3], sel(2 * i));
        a[kk][i][3] = widen2(r[2], r[3], sel(2 * i + 1));
      }
    }
  };
  auto issue = [&](int kt, const Frags& a) {
    const uint32_t xs = x_s + (kt % kStages) * L::kXBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = gmma_desc(xs + kk * 32, 16, 1024);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (BM == 128)
          wgmma_rs_n128<0>(acc[i], a[kk][i], db, 1);
        else
          wgmma_rs_n64<0>(acc[i], a[kk][i], db, 1);
      }
    }
    wgmma_commit();
  };
  auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(kt % kStages));
  };
  // Stage kt + 1 is widened while stage kt's products run: two sets of
  // fragments, the loop unrolled by two so that each has fixed registers.
  Frags a0, a1;
  if (nk > 0) widen(0, a0);
  for (int kt = 0; kt < nk; kt += 2) {
    issue(kt, a0);
    if (kt > 0) {
      wgmma_wait<1>();
      release(kt - 1);
    }
    if (kt + 1 < nk) {
      widen(kt + 1, a1);
      issue(kt + 1, a1);
      wgmma_wait<1>();
      release(kt);
    }
    if (kt + 2 < nk) widen(kt + 2, a0);
  }
  wgmma_wait<0>();
  if (nk > 0) release(nk - 1);
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // Thread (g, t4) holds, for x row n = 8 j + 2 t4 + e of the tile,
  // columns fb .. fb + 3 of its warpgroup's 128: acc[0][4 j + e],
  // acc[0][4 j + 2 + e], acc[1][4 j + e], acc[1][4 j + 2 + e].
  const int col = f0 + 128 * c + fb;
  if (!split) {
    if (col >= f) return;  // F % 16 == 0: the 4 columns are in or out
    const float4 sc = *reinterpret_cast<const float4*>(scale + col);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * j + 2 * t4 + e;
        if (row >= m) continue;
        *reinterpret_cast<uint2*>(out + static_cast<size_t>(row) * f + col) =
            make_uint2(pack_bf16(acc[0][4 * j + e] * sc.x,
                                 acc[0][4 * j + 2 + e] * sc.y),
                       pack_bf16(acc[1][4 * j + e] * sc.z,
                                 acc[1][4 * j + 2 + e] * sc.w));
      }
    return;
  }

  named_barrier(1, 256);  // both consumers are done with the ring
  fence_proxy_async();
  float* sums = reinterpret_cast<float*>(sm);  // [BM][kSLD]
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(sums + (8 * j + 2 * t4 + e) * kSLD +
                                 128 * c + fb) =
          make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                      acc[1][4 * j + e], acc[1][4 * j + 2 + e]);
  cluster_sync_all();
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (BM + splits - 1) / splits;
  const int r_lo = rank * per;
  const int r_hi = min(BM, r_lo + per);
  for (int idx = threadIdx.x - 128; idx < (r_hi - r_lo) * (kBF / 4);
       idx += 256) {
    const int lr = r_lo + idx / (kBF / 4);
    const int c4 = (idx % (kBF / 4)) * 4;
    float4 v[kMaxSplits];  // every split's read in flight, then the sum
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < splits)
        v[z] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(sums + lr * kSLD + c4, z));
    float4 t = v[0];
#pragma unroll
    for (int z = 1; z < kMaxSplits; ++z)
      if (z < splits) {
        t.x += v[z].x;
        t.y += v[z].y;
        t.z += v[z].z;
        t.w += v[z].w;
      }
    const int row = m0 + lr;
    const int cc = f0 + c4;
    if (row >= m || cc >= f) continue;
    const float4 sc = *reinterpret_cast<const float4*>(scale + cc);
    *reinterpret_cast<uint2*>(out + static_cast<size_t>(row) * f + cc) =
        make_uint2(pack_bf16(t.x * sc.x, t.y * sc.y),
                   pack_bf16(t.z * sc.z, t.w * sc.w));
  }
  cluster_sync_all();  // no block leaves while another reads its sums
}

template <int BM>
int launch(const void* x, const void* wq, const void* scale, void* out,
           int m, int d, int f, int splits, int chunk, cudaStream_t stream) {
  using L = GemmLayout<BM>;
  CUtensorMap xm, wm;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(d),
                              static_cast<uint64_t>(m)};
  const uint64_t x_strides[1] = {2ull * d};
  const uint32_t x_box[2] = {kBK, BM};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(f),
                              static_cast<uint64_t>(d)};
  const uint64_t w_strides[1] = {static_cast<uint64_t>(f)};
  const uint32_t w_box[2] = {128, kBK};
  if (!tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims,
                  x_strides, x_box) ||
      !tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, w_dims,
                  w_strides, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr auto kernel = w8a16_wgmma_kernel<BM>;
  allow_smem_once<kernel>(L::kSmem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((f + kBF - 1) / kBF, (m + BM - 1) / BM, splits);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, xm, wm, static_cast<const float*>(scale),
      static_cast<bf16*>(out), m, d, f, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 x [M, D], wq int8 [D, F], scale float32 [F], out bf16 [M, F]; D % 8
// == 0, F % 16 == 0, every base 16-byte aligned.  tile_m: 64 or 128 rows
// of x a block; splits: chunks of D of ``chunk`` rows (a multiple of 64,
// splits * chunk >= D, at most 8: the splits of a tile are one cluster).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments out of range or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int sw_int8_matmul_wgmma(const void* x, const void* wq,
                                    const void* scale, void* out, int m,
                                    int d, int f, int tile_m, int splits,
                                    int chunk, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(wq) |
                        reinterpret_cast<uintptr_t>(scale) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (!aligned || d % 8 || f % 16 || m < 1 || splits < 1 ||
      splits > kMaxSplits || chunk < kBK || chunk % kBK ||
      static_cast<long long>(splits) * chunk < d)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_m == 128)
    return launch<128>(x, wq, scale, out, m, d, f, splits, chunk, st);
  if (tile_m == 64)
    return launch<64>(x, wq, scale, out, m, d, f, splits, chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
