// Cached GQA decode attention for C >= 1 query positions per row.
//
// Replaces the TPU kernels starway_tpu/ops/pallas_decode.py
// _decode_stream_kernel and _decode_kernel (one function, two grid
// schedules there; one kernel here).
//
// What bounds it: device-memory bytes.  Each generated token streams the
// whole live cache of every layer once, and the arithmetic per cache byte
// is n_rep * C multiply-adds, far below the card's ~295 FLOP/byte balance
// point.  The design therefore reads the grouped (narrow) cache exactly
// once per row tile: a thread block attends the n_rep query heads of one
// (batch row, kv head), packed as rows r = rep * C + ci, against each
// 32-key tile, so repeat_kv is never built.  Only the tiles holding keys
// in (pos - window, pos + C - 1] are read.  int8 caches stream at one byte
// per element with the scales folded into the algebra:
//   k_scale multiplies the score columns together with sm_scale,
//   v_scale multiplies p after l has been summed, and p is rounded to the
//   query dtype before p @ v.
// Scores, the online softmax and the accumulator are float32.
//
// B * Hkv (batch row, kv head) pairs are too few blocks for 132 SMs (64 at
// 8 slots), so the live tiles of each pair are split over n_split blocks
// (split over T).  Each writes an unnormalised partial (o, m, l) and a
// second kernel merges the partials with the online-softmax algebra.
// A block holds at most kRowTile = 64 query rows in shared memory; more
// rows (a suffix ingest of C in the hundreds) run as a third grid axis
// over row tiles, each reading only the keys its own rows see.  Cache
// tiles are read with 16-byte loads.  The tile loop is decode_tiles.cuh,
// shared with the paged kernel (paged_attention.cu).
//
// Layouts: q [B, Hq, C, D] read as [B * Hkv, R = n_rep * C, D]; caches
// [B * Hkv, T, D]; scales [B * Hkv, T] float32; pos [B] int32; partials
// o [B * Hkv, n_split, R, D], m/l [B * Hkv, n_split, R] float32.
#include "decode_tiles.cuh"

namespace {

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ pos_arr,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int hkv, int rows, int tile_rows, int n_q,
    int t_len, int window, float sm_scale) {
  const int bh = blockIdx.x;
  attend_rows<TQ, TKV, D>(
      q + static_cast<size_t>(bh) * rows * D, k, v, k_scale, v_scale,
      DenseRows{static_cast<size_t>(bh) * t_len}, pos_arr[bh / hkv], o_part,
      m_part, l_part, static_cast<size_t>(bh) * gridDim.y + blockIdx.y, rows,
      tile_rows, n_q, t_len, window, sm_scale);
}

template <typename TQ, typename TKV, int D>
void launch_d(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* pos, float* o_part, float* m_part,
              float* l_part, int b, int hkv, int n_split, int rows, int n_q,
              int t_len, int window, float sm_scale, cudaStream_t stream) {
  const int tr = row_tile(rows);
  const size_t smem = smem_bytes(tr, D);
  auto kernel = decode_partial_kernel<TQ, TKV, D>;
  sw_allow_smem(kernel, smem);
  kernel<<<dim3(b * hkv, n_split, (rows + tr - 1) / tr), kThreads, smem,
           stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos), o_part,
      m_part, l_part, hkv, rows, tr, n_q, t_len, window, sm_scale);
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* out, float* o_part,
           float* m_part, float* l_part, int b, int hkv, int n_split,
           int rows, int n_q, int t_len, int d, int window, float sm_scale,
           cudaStream_t st) {
#define SW_DECODE_CASE(DD)                                                   \
  case DD:                                                                   \
    launch_d<TQ, TKV, DD>(q, k, v, ks, vs, pos, o_part, m_part, l_part, b,   \
                          hkv, n_split, rows, n_q, t_len, window, sm_scale,  \
                          st);                                               \
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
  return launch_combine<TQ>(o_part, m_part, l_part, out, b * hkv, n_split,
                            rows, d, st);
}

}  // namespace

// Shared memory bytes one partial block needs for `rows` query rows per
// (batch row, kv head): at most kRowTile of them sit in one block.  The
// wrapper checks the card's limit before launching.
extern "C" size_t sw_decode_attention_smem(int rows, int d) {
  return smem_bytes(row_tile(rows), d);
}

// q_bf16: 1 for bfloat16 queries/outputs, 0 for float32.  kv_int8: 1 for
// int8 caches with float32 scales, 0 for caches in the query dtype.
// window: 0 for none.  d in {16, 32, 64, 128, 256}.  o_part/m_part/l_part:
// float32 scratch of [B * Hkv, n_split, rows(, d)].  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for an
// unsupported d).
extern "C" int sw_decode_attention(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* pos,
                                   void* out, void* o_part, void* m_part,
                                   void* l_part, int b, int hkv, int n_split,
                                   int rows, int n_q, int t_len, int d,
                                   int window, int q_bf16, float sm_scale,
                                   int kv_int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  if (q_bf16) {
    if (kv_int8)
      return launch<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale, pos,
                                           out, op, mp, lp, b, hkv, n_split,
                                           rows, n_q, t_len, d, window,
                                           sm_scale, st);
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, pos, out, op, mp, lp, b, hkv, n_split,
        rows, n_q, t_len, d, window, sm_scale, st);
  }
  if (kv_int8)
    return launch<float, int8_t>(q, k, v, k_scale, v_scale, pos, out, op, mp,
                                 lp, b, hkv, n_split, rows, n_q, t_len, d,
                                 window, sm_scale, st);
  return launch<float, float>(q, k, v, nullptr, nullptr, pos, out, op, mp, lp,
                              b, hkv, n_split, rows, n_q, t_len, d, window,
                              sm_scale, st);
}
