// GQA flash-attention forward: causal or not, kv padding, sliding window.
//
// Replaces the TPU kernel starway_tpu/ops/pallas_attention.py _fwd_kernel
// (with _mask_scores; called from _fwd_impl).
//
// What bounds it: operations.  A causal pass over S tokens does about
// 2 * S^2 * D multiply-adds per head against O(S * D) bytes, far above the
// card's ~295 FLOP/byte balance point at prompt lengths of a few hundred
// and more.  The design keeps the [S, S] score matrix out of device memory:
// one thread block per (batch * q head, 64-row q tile) loops over 64-key
// kv tiles held in shared memory with the online softmax, and reads each
// tile once per q tile.  The kv head is h / n_rep, so the grouped cache is
// never expanded.  Tiles past the causal diagonal or wholly below every
// row's window are neither read nor computed.  Scores, softmax statistics
// and the accumulator are float32; p is rounded to the input dtype before
// p @ v.  It writes o and the row log-sum-exp lse [B, Hq, S] float32.
//
// Known limit of this first version: the products run on the float32 FMA
// units (register-tiled 4 x 4 and 4 x D/16 per thread), not on the tensor
// cores; a wgmma pipeline is the planned remedy.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid of threads

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int hq, int hkv, int s_len, int kv_len, int causal, int window,
    float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int SP = kBK + 1;
  constexpr int NJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [kBQ][D]
  float* k_s = q_s + kBQ * D;     // [kBK][D + 1]
  float* v_s = k_s + kBK * DP;    // [kBK][D]
  float* s_s = v_s + kBK * D;     // [kBQ][kBK + 1]
  float* m_s = s_s + kBQ * SP;    // [kBQ]
  float* l_s = m_s + kBQ;         // [kBQ]
  float* c_s = l_s + kBQ;         // [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const T* qb = q + static_cast<size_t>(bh) * s_len * D;
  const T* kb = k + static_cast<size_t>(kvh) * kv_len * D;
  const T* vb = v + static_cast<size_t>(kvh) * kv_len * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    q_s[i] = q0 + r < s_len ? sw_to_float(qb[static_cast<size_t>(q0) * D + i])
                            : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = SW_NEG_BIG;
    l_s[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_k = (kv_len + kBK - 1) / kBK;
  int k_first = 0, k_last = n_k - 1;
  if (causal) {
    k_last = min(k_last, (q0 + kBQ - 1) / kBK);
    if (window > 0) k_first = max(q0 - (window - 1), 0) / kBK;
  }
  __syncthreads();

  for (int kt = k_first; kt <= k_last; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D;
      const int c = i - j * D;
      float kv = 0.f, vv = 0.f;
      if (k0 + j < kv_len) {
        const size_t off = static_cast<size_t>(k0) * D + i;
        kv = sw_to_float(kb[off]);
        vv = sw_to_float(vb[off]);
      }
      k_s[j * DP + c] = kv;
      v_s[i] = vv;
    }
    __syncthreads();

    // Scores: rows ty + 16 i, keys tx + 16 j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * D + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = k_s[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        bool keep = kp < kv_len;
        if (causal) {
          keep = keep && qp >= kp;
          if (window > 0) keep = keep && kp > qp - window;
        }
        s_s[r * SP + c] = keep ? sc[i][j] * sm_scale : SW_NEG_BIG;
      }
    }
    __syncthreads();

    // Online softmax: four threads per row, 16 keys each.
    {
      const int r = tid >> 2;
      const int sub = tid & 3;
      float mx = SW_NEG_BIG;
      for (int c = sub; c < kBK; c += 4) mx = fmaxf(mx, s_s[r * SP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      // A row whose window starts in a later tile is fully masked here:
      // clamping exp's argument keeps its p at exactly 0.
      const float m_use = fmaxf(m_new, SW_NEG_BIG / 2);
      float sum = 0.f;
      for (int c = sub; c < kBK; c += 4) {
        const float p = expf(s_s[r * SP + c] - m_use);
        sum += p;
        s_s[r * SP + c] = sw_round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (sub == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v: rows ty + 16 i, columns tx + 16 j.
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) corr[i] = c_s[ty + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr[i];
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* ob = o + static_cast<size_t>(bh) * s_len * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= s_len) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[static_cast<size_t>(q0 + r) * D + tx + 16 * j] =
          sw_from_float<T>(acc[i][j] / l);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * s_len + q0 + r] = m_s[r] + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int hq, int hkv, int s_len, int kv_len, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D +
                                       kBQ * (kBK + 1) + 3 * kBQ);
  auto kernel = flash_fwd_kernel<T, D>;
  sw_allow_smem(kernel, smem);
  dim3 grid((s_len + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), hq, hkv, s_len, kv_len, causal, window,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int b, int hq, int hkv, int s_len, int kv_len, int d,
             int causal, int window, float sm_scale, cudaStream_t st) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, b, hq, hkv, s_len, kv_len,
                           causal, window, sm_scale, st);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, b, hq, hkv, s_len, kv_len,
                           causal, window, sm_scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, hq, hkv, s_len, kv_len,
                           causal, window, sm_scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, hq, hkv, s_len, kv_len,
                            causal, window, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Hq, S, D], k/v [B, Hkv, Skv, D], o like q, lse [B, Hq, S] float32.
// D in {16, 32, 64, 128}; window 0 for none.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported D).
extern "C" int sw_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int b, int hq, int hkv,
                            int s_len, int kv_len, int d, int causal,
                            int window, float sm_scale, int is_bf16,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, b, hq, hkv, s_len,
                                   kv_len, d, causal, window, sm_scale, st);
  return dispatch<float>(q, k, v, o, lse, b, hq, hkv, s_len, kv_len, d,
                         causal, window, sm_scale, st);
}
