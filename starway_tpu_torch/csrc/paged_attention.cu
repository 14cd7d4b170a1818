// Decode attention over a paged KV pool, through a block table.
//
// Replaces the TPU kernel starway_tpu/ops/pallas_paged.py
// _paged_stream_kernel (entry paged_decode_attention).
//
// Page i of slot b holds positions i * page .. (i + 1) * page - 1 and is
// pool page table[b, i]: key position kp of the slot lives at row
// kp % page of pool page table[b, kp / page].  The TPU kernel streams whole
// pages with double-buffered DMA; here the dense kernel's tile loops
// (csrc/decode_tiles.cuh) run unchanged and only the address of a key row
// differs, so any page size works: a 64-key tile may span pages (16, 32)
// or lie inside one (64, 128).  A thread resolves a page once (a shift for
// a power-of-two page; once a tile where the page holds the tile), and a
// page id is read only for a key below the row tile's last query position
// (kp <= pos + C - 1), so table entries past the cursor, which may be
// anything, are never read, also by a stage copied ahead.
//
// What bounds it: as the dense kernel (csrc/decode_attention.cu), bytes
// at decode and operations at a prefix's suffix ingest (C = the suffix
// bucket).  bfloat16 queries and pools: paged_mma_kernel, one launch a call
// (attend_mma: cp.async ring, mma.sync, the split over T merged in a
// thread block cluster); 16 slots x 8 kv heads are 128 (slot, kv head)
// pairs for 132 SMs, so the split (ops/decode.py decode_plan) brings the
// grid to about two blocks an SM.  Registers a thread (ptxas, sm_90a) at
// D = 128: 152 decode regime, 173 ingest; no spills.  float32 (the parity
// runs): paged_partial_kernel on the FMA loop and the combine kernel.
// Next: the page rows by TMA and wgmma, as the dense kernel's notes say.
//
// Layouts: q [B, Hq, C, D] read as [B * Hkv, R = n_rep * C, D]; pools
// [n_pages, Hkv, page, D] in q's dtype (int8 pools are refused by the
// wrapper); table [B, max_pages] int32; pos [B] int32 (or one value,
// for both dtypes);
// float32 partials as the dense kernel's.  Offsets are size_t: a pool at
// the serving size holds tens of millions of elements per layer.
#include "decode_tiles.cuh"

namespace {

// ------------------------------------------------------ bfloat16, mma.sync

struct PagedArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* table;
  const int* pos;  // [B] (pos_stride 1), one value (0), or nullptr
  int pos_stride;
  int pos_value;   // the position of every row where pos is nullptr
  bf16* out;
  int hkv, rows, n_q, max_pages, page, page_shift;
  float sm_scale;
};

template <int D, bool kDecode>
__global__ void __launch_bounds__(kMmaThreads)
    paged_mma_kernel(const PagedArgs a) {
  const int bh = blockIdx.z;
  const int b = bh / a.hkv;
  const int pos = a.pos ? a.pos[b * a.pos_stride] : a.pos_value;
  const PagedRows key_row{a.table + static_cast<size_t>(b) * a.max_pages,
                          a.page, a.page_shift, a.hkv, bh - b * a.hkv};
  const size_t q0 = static_cast<size_t>(bh) * a.rows * D;
  attend_mma<bf16, D, kDecode>(a.q + q0, a.k, a.v, nullptr, nullptr, key_row,
                               pos, a.out + q0, a.rows, a.n_q,
                               a.max_pages * a.page, 0, a.sm_scale);
}

template <int D>
int launch_mma(const PagedArgs& a, int bh, int n_split, int decode,
               cudaStream_t st) {
  using ShD = MmaShape<bf16, D, true>;
  using ShI = MmaShape<bf16, D, false>;
  const int rt = decode ? ShD::kRows : ShI::kRows;
  const dim3 grid(n_split, (a.rows + rt - 1) / rt, bh);
  if (decode)
    return launch_cluster(paged_mma_kernel<D, true>, grid, ShD::kSmem, st,
                          a);
  return launch_cluster(paged_mma_kernel<D, false>, grid, ShI::kSmem, st, a);
}

// ---------------------------------------------------------------- float32

template <int D>
__global__ void __launch_bounds__(kFmaThreads) paged_partial_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ pos_arr, int pos_stride, int pos_value,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int hkv, int rows, int tile_rows, int n_q,
    int max_pages, int page, float sm_scale) {
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int pos = pos_arr ? pos_arr[b * pos_stride] : pos_value;
  const PagedRows key_row{table + static_cast<size_t>(b) * max_pages, page,
                          -1, hkv, bh - b * hkv};
  attend_rows<D>(q + static_cast<size_t>(bh) * rows * D, k_pool, v_pool,
                 nullptr, nullptr, key_row, pos, o_part, m_part,
                 l_part, static_cast<size_t>(bh) * gridDim.y + blockIdx.y,
                 rows, tile_rows, n_q, max_pages * page, 0, sm_scale);
}

template <int D>
void launch_fma_d(const void* q, const void* k, const void* v,
                  const void* table, const void* pos, int pos_stride,
                  int pos_value, float* o_part, float* m_part, float* l_part,
                  int b, int hkv, int n_split, int rows, int n_q,
                  int max_pages, int page, float sm_scale,
                  cudaStream_t stream) {
  const int tr = fma_row_tile(rows);
  const size_t smem = fma_smem_bytes(tr, D);
  auto kernel = paged_partial_kernel<D>;
  sw_allow_smem(kernel, smem);
  kernel<<<dim3(b * hkv, n_split, (rows + tr - 1) / tr), kFmaThreads, smem,
           stream>>>(static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const int*>(table),
                     static_cast<const int*>(pos), pos_stride, pos_value,
                     o_part, m_part, l_part, hkv, rows, tr, n_q, max_pages,
                     page, sm_scale);
}

}  // namespace

// bfloat16 q [B, Hq, C, D], pools and output.  page_shift: log2(page)
// where page is a power of two, else -1.  Otherwise as
// sw_decode_attention (csrc/decode_attention.cu).
extern "C" int sw_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const void* table,
                                  const void* pos, int pos_stride,
                                  int pos_value, void* out, int b, int hkv,
                                  int rows, int n_q, int max_pages, int page,
                                  int page_shift, int d, float sm_scale,
                                  int decode, int n_split, void* stream) {
  if (n_split < 1 || n_split > max_splits(d) || (decode && rows > 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedArgs a{static_cast<const bf16*>(q),
                    static_cast<const bf16*>(k_pool),
                    static_cast<const bf16*>(v_pool),
                    static_cast<const int*>(table),
                    static_cast<const int*>(pos),
                    pos_stride,
                    pos_value,
                    static_cast<bf16*>(out),
                    hkv,
                    rows,
                    n_q,
                    max_pages,
                    page,
                    page_shift,
                    sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch_mma<16>(a, b * hkv, n_split, decode, st);
    case 32:
      return launch_mma<32>(a, b * hkv, n_split, decode, st);
    case 64:
      return launch_mma<64>(a, b * hkv, n_split, decode, st);
    case 128:
      return launch_mma<128>(a, b * hkv, n_split, decode, st);
    case 256:
      return launch_mma<256>(a, b * hkv, n_split, decode, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// float32 q, pools and output; o_part/m_part/l_part: float32 scratch of
// [B * Hkv, n_split, rows(, d)].  pos as sw_paged_attention's.  Returns
// cudaGetLastError() after the two launches (cudaErrorInvalidValue for an
// unsupported d).
extern "C" int sw_paged_attention_fma(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* pos, int pos_stride,
                                      int pos_value, void* out,
                                      void* o_part, void* m_part,
                                      void* l_part, int b, int hkv,
                                      int n_split, int rows, int n_q,
                                      int max_pages, int page, int d,
                                      float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
#define SW_PAGED_CASE(DD)                                                   \
  case DD:                                                                  \
    launch_fma_d<DD>(q, k_pool, v_pool, table, pos, pos_stride, pos_value, \
                     op, mp, lp, b, hkv, n_split, rows, n_q, max_pages,     \
                     page, sm_scale, st);                                   \
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
  return launch_combine(op, mp, lp, out, b * hkv, n_split, rows, d, st);
}
