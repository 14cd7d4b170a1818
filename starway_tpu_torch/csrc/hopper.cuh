// Hopper's own tensor cores and copies for csrc/w8a16_wgmma.cu,
// csrc/flash_fwd_wgmma.cu and csrc/flash_bwd_wgmma.cu: TMA tensor maps
// (encoded on the host, cached), TMA loads and mbarriers, warpgroup
// matrix multiplies (wgmma) with their shared-memory descriptors, register
// reallocation between warpgroups (setmaxnreg), and the cluster barrier.
// Every tile a kernel reads by TMA is a box of 64 bf16 (or 128 int8)
// columns, 128 bytes a row, stored with the 128-byte swizzle (16-byte chunk
// c of row r at chunk c ^ (r & 7)), the layout wgmma's descriptors name as
// "128B".  Everything sits in an anonymous namespace: each source that
// includes this gets its own copy, its tensor-map cache included.
#pragma once

// CUtensorMap and its enums only: nothing links libcuda.
#include <cuda.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

#include "ptx.cuh"

namespace {

// ------------------------------------------------------- host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library needs no -lcuda; nullptr when the entry point is missing.
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of a row-major tensor of ``rank`` (2 or 3) dimensions,
// innermost first (``dims``), with the byte strides of the outer ones, read
// in boxes of ``box`` elements, 128-byte swizzled; elements out of bounds
// read as zeros.  Encoding costs host time on paths that launch hundreds
// of kernels a step, so maps are cached by everything that defines them
// (a static weight's hits on every call; the cache is dropped whole when it
// grows past 4096 maps).  Returns false when the encoder refuses the map.
inline bool tensor_map(CUtensorMap* out, CUtensorMapDataType type, int rank,
                       const void* ptr, const uint64_t* dims,
                       const uint64_t* strides, const uint32_t* box) {
  using Key = std::array<uint64_t, 12>;
  static std::mutex lock;
  static std::map<Key, CUtensorMap> cache;
  Key key{};
  key[0] = reinterpret_cast<uint64_t>(ptr);
  key[1] = static_cast<uint64_t>(type) | (static_cast<uint64_t>(rank) << 32);
  for (int i = 0; i < rank; ++i) {
    key[2 + i] = dims[i];
    key[5 + i] = box[i];
    if (i + 1 < rank) key[8 + i] = strides[i];
  }
  std::lock_guard<std::mutex> guard(lock);
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return true;
  }
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], e[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) s[i] = strides[i];
  }
  if (encode(out, type, rank, const_cast<void*>(ptr), d, s, b, e,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *out);
  return true;
}

// A [B * H, S, D] bf16 tensor (the flash kernels' q, k, v, dO) read in
// boxes of 64 columns x 64 rows of one head: rows past S read as zeros,
// and no box crosses into the next head.
inline bool head_map(CUtensorMap* map, const void* p, int bh, int s, int d) {
  const uint64_t dims[3] = {static_cast<uint64_t>(d),
                            static_cast<uint64_t>(s),
                            static_cast<uint64_t>(bh)};
  const uint64_t strides[2] = {2ull * d, 2ull * d * s};
  const uint32_t box[3] = {64, 64, 1};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p, dims,
                    strides, box);
}

// ``K``'s dynamic shared memory limit, set once (the attribute is the
// kernel's, not the launch's).
template <auto K>
inline void allow_smem_once(size_t bytes) {
  static const bool done = [bytes] {
    cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    return true;
  }();
  (void)done;
}

// ------------------------------------------------------ device: copies

// Dynamic shared memory rounded up to the 1024 bytes the 128-byte swizzle
// repeats over (the kernels ask for 1024 bytes more than they use).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// The barriers' initialisation, visible to the TMA unit and the cluster.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread arrives and the phase now also waits for ``bytes`` of TMA.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// The phase also waits for ``bytes`` of TMA; this thread does not arrive.
__device__ __forceinline__ void mbar_expect_bytes(uint32_t bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Box at (c0, c1[, c2]) of ``map`` into shared memory at ``dst``; its bytes
// complete a transaction on ``bar``.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Orders this thread's generic-proxy accesses to shared memory with the
// async proxy's (TMA, wgmma) to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------- device: warpgroups

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier ``id`` (1-15; 0 is __syncthreads) over ``count`` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Every thread of every block of the cluster arrives, then waits for all;
// release / acquire order the blocks' shared memory.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// A wgmma operand in shared memory: a tile of 128-byte swizzled rows from
// ``addr`` (the swizzle atom is 8 rows, 1024 bytes, and the tile's base is
// 1024-byte aligned); ``lbo`` the bytes between atoms along M or N of an
// MN-major operand (unused K-major), ``sbo`` between 8-row groups.  A
// K-major operand's next k16 step is 32 bytes on; an MN-major one's 16 rows
// (2048 bytes) on.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Before a warpgroup's first wgmma that reads registers other instructions
// wrote (accumulators, A fragments).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties an accumulator array to this point of the program: its registers
// are neither read before a preceding wgmma_wait nor written after a
// following wgmma is issued.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A [64 x 64] accumulator (mma.sync's m16n8 tiles side by side) rounded
// to bf16 as the register A fragments of a product over its 64 columns:
// n8 tiles 2 kq and 2 kq + 1 are k-step kq.
__device__ __forceinline__ void pack_frags(const float (&x)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kq][r] = pack_bf16(x[8 * kq + 2 * r], x[8 * kq + 2 * r + 1]);
}

// d[64 x 64] (+)= a[64 x 16] b[16 x 64], a and b from shared memory, both
// K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= a[64 x 16] b[16 x 64], a from registers (the m16k16
// fragment layout of mma.sync, warp w of the warpgroup holding rows
// 16 w .. 16 w + 15), b from shared memory, K-major (TB 0) or MN-major
// (TB 1); scale_d 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// d[64 x 128] (+)= a[64 x 16] b[16 x 128], a from registers (the m16k16
// fragment layout of mma.sync, warp w of the warpgroup holding rows
// 16 w .. 16 w + 15), b from shared memory, K-major (TB 0) or MN-major
// (TB 1); scale_d 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

}  // namespace
