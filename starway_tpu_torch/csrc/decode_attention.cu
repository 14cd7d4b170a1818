// Cached GQA decode attention for C >= 1 query positions per row.
//
// Replaces the TPU kernels starway_tpu/ops/pallas_decode.py
// _decode_stream_kernel and _decode_kernel (one function, two grid
// schedules there; one kernel here).
//
// What bounds it: device-memory bytes at decode (C = 1: each generated
// token streams the live cache of every layer once, n_rep multiply-adds a
// cache element, far below the card's ~295 FLOP/byte balance point);
// operations at a suffix ingest (C in the hundreds: n_rep * C query rows
// against each key, a flash forward at query offset pos).  The grouped
// (narrow) cache is read once per tile of query rows: a block attends the
// n_rep query heads of one (batch row, kv head), packed as rows r = rep * C
// + ci, so repeat_kv is never built, and only the tiles holding keys in
// (pos - window, pos + C - 1] are read.  int8 caches stream at one byte an
// element with the scales folded into the algebra: k_scale multiplies the
// score columns together with sm_scale, v_scale multiplies p after l has
// been summed, and p is rounded to the query dtype before p @ v.  Scores,
// the online softmax and the accumulator are float32.
//
// bfloat16 queries (bf16 or int8 caches): decode_mma_kernel, one launch a
// call, on the tensor cores (csrc/decode_tiles.cuh attend_mma: 64-key
// tiles streamed by cp.async into a 2-stage ring, mma.sync.m16n8k16 for
// q k^T and p v, int8 widened to bf16 in registers; the decode regime
// (n_rep * C <= 16 rows; here only at head sizes 16, 32 and 256) splits
// each tile's keys over the warps, the ingest regime runs 64-row tiles of
// 16 rows a warp; the split over T is one thread block cluster whose
// blocks merge their partials over distributed shared memory).
// ops/decode.py decode_plan picks the regime and the split from the
// shapes and the card's SM count; the kernel finds each split's tiles
// from pos on the device.  Registers a thread (ptxas, sm_90a,
// chip_smoke.py's register report) at D = 128: ingest 172 (int8 caches
// 177); no spills at any compiled head size.  Shared memory at D = 128:
// 85 KB an ingest block (two an SM).
//
// float32 queries (the parity runs): the FMA loop, decode_partial_kernel
// and decode_combine_kernel (partials in device memory).  The dispatch is
// by dtype, not a fallback: a bf16 tensor always reaches the tensor cores.
//
// The decode regime at head sizes 64 and 128 (every decode step of the
// serving paths, and the chunk verify at C <= 4) runs csrc/decode_tma.cu
// instead: the K/V stream by TMA into an mbarrier-guarded ring filled by
// one producer warp, the products on wgmma, and a split over T past one
// cluster (ops/decode.py tma_route).  This kernel keeps the ingest regime,
// whose products could move onto csrc/flash_fwd_wgmma.cu's loop (a later
// change), the head sizes 16, 32 and 256, and float32.
//
// Layouts: q [B, Hq, C, D] read as [B * Hkv, R = n_rep * C, D]; caches
// [B * Hkv, T, D]; scales [B * Hkv, T] float32; pos [B] int32 (or one
// value, for both dtypes); float32 partials o [B * Hkv, n_split, R, D], m/l [B * Hkv,
// n_split, R].
#include "decode_tiles.cuh"

namespace {

// ------------------------------------------------------ bfloat16, mma.sync

struct DecodeArgs {
  const bf16* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* pos;  // [B] (pos_stride 1), one value (0), or nullptr
  int pos_stride;
  int pos_value;   // the position of every row where pos is nullptr
  bf16* out;
  int hkv, rows, n_q, t_len, window;
  float sm_scale;
};

template <typename TKV, int D, bool kDecode>
__global__ void __launch_bounds__(kMmaThreads)
    decode_mma_kernel(const DecodeArgs a) {
  const int bh = blockIdx.z;
  const int b = bh / a.hkv;
  const int pos = a.pos ? a.pos[b * a.pos_stride] : a.pos_value;
  const size_t q0 = static_cast<size_t>(bh) * a.rows * D;
  attend_mma<TKV, D, kDecode>(
      a.q + q0, static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      a.k_scale, a.v_scale, DenseRows{static_cast<size_t>(bh) * a.t_len},
      pos, a.out + q0, a.rows, a.n_q, a.t_len, a.window, a.sm_scale);
}

// The decode regime at head sizes 64 and 128 is csrc/decode_tma.cu's.
template <int D>
constexpr bool has_decode_regime() {
  return D != 64 && D != 128;
}

template <typename TKV, int D>
int launch_mma(const DecodeArgs& a, int bh, int n_split, int decode,
               cudaStream_t st) {
  if (!decode) {
    using ShI = MmaShape<TKV, D, false>;
    const dim3 grid(n_split, (a.rows + ShI::kRows - 1) / ShI::kRows, bh);
    return launch_cluster(decode_mma_kernel<TKV, D, false>, grid, ShI::kSmem,
                          st, a);
  }
  if constexpr (has_decode_regime<D>()) {
    using ShD = MmaShape<TKV, D, true>;
    const dim3 grid(n_split, (a.rows + ShD::kRows - 1) / ShD::kRows, bh);
    return launch_cluster(decode_mma_kernel<TKV, D, true>, grid, ShD::kSmem,
                          st, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TKV>
int run_mma(const DecodeArgs& a, int bh, int n_split, int decode, int d,
            cudaStream_t st) {
  switch (d) {
    case 16:
      return launch_mma<TKV, 16>(a, bh, n_split, decode, st);
    case 32:
      return launch_mma<TKV, 32>(a, bh, n_split, decode, st);
    case 64:
      return launch_mma<TKV, 64>(a, bh, n_split, decode, st);
    case 128:
      return launch_mma<TKV, 128>(a, bh, n_split, decode, st);
    case 256:
      return launch_mma<TKV, 256>(a, bh, n_split, decode, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TKV>
size_t mma_smem(int decode, int d) {
  switch (d) {
#define SW_SMEM_CASE(DD)                                     \
  case DD:                                                   \
    return decode ? MmaShape<TKV, DD, true>::kSmem           \
                  : MmaShape<TKV, DD, false>::kSmem;
    SW_SMEM_CASE(16)
    SW_SMEM_CASE(32)
    SW_SMEM_CASE(256)
#undef SW_SMEM_CASE
    case 64:
      return decode ? 0 : MmaShape<TKV, 64, false>::kSmem;
    case 128:
      return decode ? 0 : MmaShape<TKV, 128, false>::kSmem;
    default:
      return 0;
  }
}

// ---------------------------------------------------------------- float32

template <typename TKV, int D>
__global__ void __launch_bounds__(kFmaThreads) decode_partial_kernel(
    const float* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ pos_arr,
    int pos_stride, int pos_value, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int hkv,
    int rows, int tile_rows, int n_q, int t_len, int window,
    float sm_scale) {
  const int bh = blockIdx.x;
  const int pos = pos_arr ? pos_arr[bh / hkv * pos_stride] : pos_value;
  attend_rows<D>(
      q + static_cast<size_t>(bh) * rows * D, k, v, k_scale, v_scale,
      DenseRows{static_cast<size_t>(bh) * t_len}, pos, o_part,
      m_part, l_part, static_cast<size_t>(bh) * gridDim.y + blockIdx.y, rows,
      tile_rows, n_q, t_len, window, sm_scale);
}

template <typename TKV, int D>
void launch_fma_d(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* pos,
                  int pos_stride, int pos_value, float* o_part,
                  float* m_part, float* l_part, int b, int hkv, int n_split,
                  int rows, int n_q, int t_len, int window, float sm_scale,
                  cudaStream_t stream) {
  const int tr = fma_row_tile(rows);
  const size_t smem = fma_smem_bytes(tr, D);
  auto kernel = decode_partial_kernel<TKV, D>;
  sw_allow_smem(kernel, smem);
  kernel<<<dim3(b * hkv, n_split, (rows + tr - 1) / tr), kFmaThreads, smem,
           stream>>>(
      static_cast<const float*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      pos_stride, pos_value, o_part, m_part, l_part, hkv, rows, tr, n_q,
      t_len, window, sm_scale);
}

template <typename TKV>
int launch_fma(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* pos, int pos_stride,
               int pos_value, void* out, float* o_part, float* m_part,
               float* l_part, int b, int hkv, int n_split, int rows, int n_q,
               int t_len, int d, int window, float sm_scale,
               cudaStream_t st) {
#define SW_DECODE_CASE(DD)                                                 \
  case DD:                                                                 \
    launch_fma_d<TKV, DD>(q, k, v, ks, vs, pos, pos_stride, pos_value,     \
                          o_part, m_part, l_part, b, hkv, n_split, rows,   \
                          n_q, t_len, window, sm_scale, st);               \
    break;
  switch (d) {
    SW_DECODE_CASE(16)
    SW_DECODE_CASE(32)
    SW_DECODE_CASE(64)
    SW_DECODE_CASE(128)
    SW_DECODE_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SW_DECODE_CASE
  return launch_combine(o_part, m_part, l_part, out, b * hkv, n_split, rows,
                        d, st);
}

}  // namespace

// Shared memory bytes one block needs: the bf16 kernel's (q_bf16 1) for
// its regime (decode 1: at most 16 rows; 0: ingest) and cache type, or the
// float32 FMA block's for `rows` query rows per (batch row, kv head).  The
// wrapper checks the card's limit before launching.
extern "C" size_t sw_decode_attention_smem(int rows, int d, int q_bf16,
                                           int kv_int8, int decode) {
  if (q_bf16)
    return kv_int8 ? mma_smem<int8_t>(decode, d)
                   : mma_smem<__nv_bfloat16>(decode, d);
  return fma_smem_bytes(fma_row_tile(rows), d);
}

// bfloat16 q [B, Hq, C, D] and output, caches bf16 (kv_int8 0) or int8
// with float32 scales (1).  pos: int32 device pointer read at b *
// pos_stride, or nullptr for pos_value at every row.  decode: 1 for the
// decode regime (rows <= 16; d 16, 32 or 256), 0 for the ingest regime.
// n_split: blocks of a cluster over T, 1 .. 16 (8 at d = 256).  window: 0
// for none.  d in {16, 32, 64, 128, 256}.  Returns the launch's error
// (cudaErrorInvalidValue for arguments out of range).
extern "C" int sw_decode_attention(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* pos,
                                   int pos_stride, int pos_value, void* out,
                                   int b, int hkv, int rows, int n_q,
                                   int t_len, int d, int window,
                                   float sm_scale, int kv_int8, int decode,
                                   int n_split, void* stream) {
  if (n_split < 1 || n_split > max_splits(d) || (decode && rows > 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{static_cast<const bf16*>(q),
                     k,
                     v,
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale),
                     static_cast<const int*>(pos),
                     pos_stride,
                     pos_value,
                     static_cast<bf16*>(out),
                     hkv,
                     rows,
                     n_q,
                     t_len,
                     window,
                     sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_int8) return run_mma<int8_t>(a, b * hkv, n_split, decode, d, st);
  return run_mma<__nv_bfloat16>(a, b * hkv, n_split, decode, d, st);
}

// float32 q and output; caches float32 (kv_int8 0) or int8 with float32
// scales (1).  o_part/m_part/l_part: float32 scratch of [B * Hkv, n_split,
// rows(, d)].  Otherwise as sw_decode_attention.  Returns
// cudaGetLastError() after the two launches.
extern "C" int sw_decode_attention_fma(const void* q, const void* k,
                                       const void* v, const void* k_scale,
                                       const void* v_scale, const void* pos,
                                       int pos_stride, int pos_value,
                                       void* out, void* o_part, void* m_part,
                                       void* l_part, int b, int hkv,
                                       int n_split, int rows, int n_q,
                                       int t_len, int d, int window,
                                       float sm_scale, int kv_int8,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  if (kv_int8)
    return launch_fma<int8_t>(q, k, v, k_scale, v_scale, pos, pos_stride,
                              pos_value, out, op, mp, lp, b, hkv, n_split,
                              rows, n_q, t_len, d, window, sm_scale, st);
  return launch_fma<float>(q, k, v, nullptr, nullptr, pos, pos_stride,
                           pos_value, out, op, mp, lp, b, hkv, n_split, rows,
                           n_q, t_len, d, window, sm_scale, st);
}
