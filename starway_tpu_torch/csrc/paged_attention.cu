// Decode attention over a paged KV pool, through a block table.
//
// Replaces the TPU kernel starway_tpu/ops/pallas_paged.py
// _paged_stream_kernel (entry paged_decode_attention).
//
// Page i of slot b holds positions i * page .. (i + 1) * page - 1 and is
// pool page table[b, i]: key position kp of the slot lives at row
// kp % page of pool page table[b, kp / page].  The TPU kernel streams whole
// pages with double-buffered DMA; here the tile loop of the dense kernel
// (decode_tiles.cuh) runs unchanged and only the address of each key row
// differs, so any page size works: a 32-key tile may span pages (page 16)
// or lie inside one (64, 128).  A page id is read only for a key below
// the row tile's last query position (kp <= pos + C - 1), so table
// entries past the cursor, which may be anything, are never read.
//
// What bounds it: device-memory bytes, as the dense kernel: the live pages
// are read once, narrow (the n_rep query heads of a kv head share each
// tile).  The page indirection costs one cached table load per 16-byte
// vector.  16 slots x 8 kv heads are 128 (slot, kv head) pairs for 132
// SMs, so the live tiles are split over T with a combine kernel, and more
// than kRowTile query rows (a suffix ingest) run as a grid axis over row
// tiles.
//
// Layouts: q [B, Hq, C, D] read as [B * Hkv, R = n_rep * C, D]; pools
// [n_pages, Hkv, page, D] in q's dtype (int8 pools are refused by the
// wrapper); table [B, max_pages] int32; pos [B] int32; partials as the
// dense kernel's.  Offsets are size_t: a pool at the serving size holds
// tens of millions of elements per layer.
#include "decode_tiles.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ pos_arr, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int hkv,
    int rows, int tile_rows, int n_q, int max_pages, int page,
    float sm_scale) {
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const PagedRows key_row{table + static_cast<size_t>(b) * max_pages, page,
                          hkv, bh - b * hkv};
  attend_rows<T, T, D>(q + static_cast<size_t>(bh) * rows * D, k_pool,
                       v_pool, nullptr, nullptr, key_row, pos_arr[b], o_part,
                       m_part, l_part,
                       static_cast<size_t>(bh) * gridDim.y + blockIdx.y, rows,
                       tile_rows, n_q, max_pages * page, 0, sm_scale);
}

template <typename T, int D>
void launch_d(const void* q, const void* k, const void* v, const void* table,
              const void* pos, float* o_part, float* m_part, float* l_part,
              int b, int hkv, int n_split, int rows, int n_q, int max_pages,
              int page, float sm_scale, cudaStream_t stream) {
  const int tr = row_tile(rows);
  const size_t smem = smem_bytes(tr, D);
  auto kernel = paged_partial_kernel<T, D>;
  sw_allow_smem(kernel, smem);
  kernel<<<dim3(b * hkv, n_split, (rows + tr - 1) / tr), kThreads, smem,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const int*>(table),
                     static_cast<const int*>(pos), o_part, m_part, l_part,
                     hkv, rows, tr, n_q, max_pages, page, sm_scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* pos, void* out, float* o_part, float* m_part,
           float* l_part, int b, int hkv, int n_split, int rows, int n_q,
           int max_pages, int page, int d, float sm_scale, cudaStream_t st) {
#define SW_PAGED_CASE(DD)                                                    \
  case DD:                                                                   \
    launch_d<T, DD>(q, k, v, table, pos, o_part, m_part, l_part, b, hkv,     \
                    n_split, rows, n_q, max_pages, page, sm_scale, st);      \
    break;
  switch (d) {
    SW_PAGED_CASE(16)
    SW_PAGED_CASE(32)
    SW_PAGED_CASE(64)
    SW_PAGED_CASE(128)
    SW_PAGED_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SW_PAGED_CASE
  return launch_combine<T>(o_part, m_part, l_part, out, b * hkv, n_split,
                           rows, d, st);
}

}  // namespace

// q_bf16: 1 for bfloat16 queries, pools and outputs, 0 for float32.
// d in {16, 32, 64, 128, 256}.  o_part/m_part/l_part: float32 scratch of
// [B * Hkv, n_split, rows(, d)].  Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for an unsupported d).
extern "C" int sw_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const void* table,
                                  const void* pos, void* out, void* o_part,
                                  void* m_part, void* l_part, int b, int hkv,
                                  int n_split, int rows, int n_q,
                                  int max_pages, int page, int d, int q_bf16,
                                  float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  if (q_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, pos, out, op, mp,
                                 lp, b, hkv, n_split, rows, n_q, max_pages,
                                 page, d, sm_scale, st);
  return launch<float>(q, k_pool, v_pool, table, pos, out, op, mp, lp, b, hkv,
                       n_split, rows, n_q, max_pages, page, d, sm_scale, st);
}
