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
// once: a thread block attends all n_rep query heads of one (batch row, kv
// head), packed as rows r = rep * C + ci, against each 32-key tile, so
// repeat_kv is never built.  Only the tiles holding keys in
// (pos - window, pos + C - 1] are read.  int8 caches stream at one byte
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
// Cache tiles are read with 16-byte loads.
//
// Layouts: q [B, Hq, C, D] read as [B * Hkv, R = n_rep * C, D]; caches
// [B * Hkv, T, D]; scales [B * Hkv, T] float32; pos [B] int32; partials
// o [B * Hkv, n_split, R, D], m/l [B * Hkv, n_split, R] float32.
#include "common.cuh"

namespace {

constexpr int kBK = 32;        // keys per tile: one per lane in the softmax
constexpr int kThreads = 128;  // four warps

// Load `n` valid rows (of kBK) of a [*, D] tile into float shared memory
// (row stride `stride`), zero-filling the rest, with 16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src, int n) {
  constexpr int kPer = 16 / sizeof(T);          // elements per 16 bytes
  constexpr int kVecRow = D / kPer;             // 16-byte vectors per row
  constexpr int kVecs = kBK * kVecRow;
  constexpr int kIters = (kVecs + kThreads - 1) / kThreads;
  uint4 buf[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const int row = c / kVecRow;
    buf[it] = make_uint4(0, 0, 0, 0);
    if (c < kVecs && row < n)
      buf[it] = reinterpret_cast<const uint4*>(src)[c];
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = threadIdx.x + it * kThreads;
    if (c >= kVecs) break;
    const int row = c / kVecRow;
    const int col = (c - row * kVecRow) * kPer;
    const T* e = reinterpret_cast<const T*>(&buf[it]);
#pragma unroll
    for (int x = 0; x < kPer; ++x) dst[row * stride + col + x] = sw_to_float(e[x]);
  }
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ pos_arr,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int hkv, int rows, int n_q, int t_len,
    int window, float sm_scale) {
  constexpr int DP = D + 1;  // padded key rows: conflict-free score loop
  extern __shared__ float smem[];
  float* q_s = smem;                 // [rows][D]
  float* acc = q_s + rows * D;       // [rows][D]
  float* k_s = acc + rows * D;       // [kBK][D + 1]
  float* v_s = k_s + kBK * DP;       // [kBK][D]
  float* p_s = v_s + kBK * D;        // [rows][kBK]
  float* m_s = p_s + rows * kBK;     // [rows]
  float* l_s = m_s + rows;           // [rows]
  float* c_s = l_s + rows;           // [rows]
  float* ks_s = c_s + rows;          // [kBK]
  float* vs_s = ks_s + kBK;          // [kBK]

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int b = bh / hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool quant = k_scale != nullptr;

  const TQ* qb = q + static_cast<size_t>(bh) * rows * D;
  for (int i = tid; i < rows * D; i += kThreads) {
    q_s[i] = sw_to_float(qb[i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = SW_NEG_BIG;
    l_s[r] = 0.f;
  }

  // This block's share of the live tiles.
  const int pos = pos_arr[b];
  const int k_end = min(pos + n_q, t_len);  // keys 0 .. pos + C - 1
  const int k_lo = window > 0 ? max(pos - window + 1, 0) : 0;
  const int t_first = k_lo / kBK;
  const int n_tiles = max((k_end + kBK - 1) / kBK - t_first, 0);
  const int per = (n_tiles + n_split - 1) / n_split;
  const int my_first = t_first + split * per;
  const int my_end = min(t_first + n_tiles, my_first + per);
  const size_t base = static_cast<size_t>(bh) * t_len;
  __syncthreads();

  for (int tile = my_first; tile < my_end; ++tile) {
    const int kt = tile * kBK;
    const int n = min(kBK, t_len - kt);  // tile rows inside the cache
    load_tile<TKV, D>(k_s, DP, k + (base + kt) * D, n);
    load_tile<TKV, D>(v_s, D, v + (base + kt) * D, n);
    if (quant && tid < kBK) {
      ks_s[tid] = tid < n ? k_scale[base + kt + tid] : 0.f;
      vs_s[tid] = tid < n ? v_scale[base + kt + tid] : 0.f;
    }
    __syncthreads();

    // Scores: a warp covers one row against the 32 keys of the tile.
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float* qr = q_s + r * D;
      const float* kr = k_s + lane * DP;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        s0 = fmaf(qr[c], kr[c], s0);
        s1 = fmaf(qr[c + 1], kr[c + 1], s1);
        s2 = fmaf(qr[c + 2], kr[c + 2], s2);
        s3 = fmaf(qr[c + 3], kr[c + 3], s3);
      }
      float s = (s0 + s1) + (s2 + s3);
      s = quant ? s * (ks_s[lane] * sm_scale) : s * sm_scale;
      const int kp = kt + lane;
      const int qp = pos + r % n_q;
      bool keep = lane < n && kp <= qp;
      if (window > 0) keep = keep && kp > qp - window;
      s = keep ? s : SW_NEG_BIG;

      // Online softmax for this row.
      float mx = s;
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float p = s > SW_NEG_BIG / 2 ? expf(s - m_new) : 0.f;
      float sum = p;
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
      if (quant) p *= vs_s[lane];  // after l: l excludes the v scale
      p_s[r * kBK + lane] = sw_round_to<TQ>(p);
    }
    __syncthreads();

    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const float* pr = p_s + r * kBK;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < kBK; j += 4) {
        a0 = fmaf(pr[j], v_s[j * D + c], a0);
        a1 = fmaf(pr[j + 1], v_s[(j + 1) * D + c], a1);
        a2 = fmaf(pr[j + 2], v_s[(j + 2) * D + c], a2);
        a3 = fmaf(pr[j + 3], v_s[(j + 3) * D + c], a3);
      }
      acc[i] = acc[i] * c_s[r] + ((a0 + a1) + (a2 + a3));
    }
    __syncthreads();
  }

  const size_t part = static_cast<size_t>(bh) * n_split + split;
  float* ob = o_part + part * rows * D;
  for (int i = tid; i < rows * D; i += kThreads) ob[i] = acc[i];
  for (int r = tid; r < rows; r += kThreads) {
    m_part[part * rows + r] = m_s[r];
    l_part[part * rows + r] = l_s[r];
  }
}

// Merge the n_split partials of each (batch row, kv head) and normalise:
// out = sum_s o_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30).
template <typename TQ>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, TQ* __restrict__ out, int n_split,
    int rows, int d) {
  const int bh = blockIdx.x;
  const size_t p0 = static_cast<size_t>(bh) * n_split;
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d;
    float mx = SW_NEG_BIG;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, m_part[(p0 + s) * rows + r]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(m_part[(p0 + s) * rows + r] - mx);
      l += l_part[(p0 + s) * rows + r] * w;
      o += o_part[(p0 + s) * rows * d + i] * w;
    }
    out[static_cast<size_t>(bh) * rows * d + i] =
        sw_from_float<TQ>(o / fmaxf(l, 1e-30f));
  }
}

size_t smem_bytes(int rows, int d) {
  return sizeof(float) * (2 * static_cast<size_t>(rows) * d + kBK * (d + 1) +
                          kBK * d + rows * kBK + 3 * rows + 2 * kBK);
}

template <typename TQ, typename TKV, int D>
void launch_d(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* pos, float* o_part, float* m_part,
              float* l_part, int b, int hkv, int n_split, int rows, int n_q,
              int t_len, int window, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(rows, D);
  auto kernel = decode_partial_kernel<TQ, TKV, D>;
  sw_allow_smem(kernel, smem);
  kernel<<<dim3(b * hkv, n_split), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos), o_part,
      m_part, l_part, hkv, rows, n_q, t_len, window, sm_scale);
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
  decode_combine_kernel<TQ><<<b * hkv, kThreads, 0, st>>>(
      o_part, m_part, l_part, static_cast<TQ*>(out), n_split, rows, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory bytes one partial block needs (the wrapper checks the
// card's limit before launching).
extern "C" size_t sw_decode_attention_smem(int rows, int d) {
  return smem_bytes(rows, d);
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
