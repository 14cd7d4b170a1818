// GQA flash-attention forward: causal or not, kv padding, sliding window,
// global [q_offset, kv_offset] coordinates; and one ring step's
// unnormalised partial.
//
// Replaces the TPU kernels starway_tpu/ops/pallas_attention.py _fwd_kernel
// (with _mask_scores; called from _fwd_impl) and _partial_kernel (entry
// flash_partial, one ring step of parallel/ring_attention.py).
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
// p @ v.
//
// Two epilogues share the tile loop (flash_tiles):
// - flash_fwd_kernel writes o = acc / l in the input dtype and the row
//   log-sum-exp lse [B, Hq, S] float32;
// - flash_partial_kernel writes the unnormalised partial of a ring step:
//   acc [B, Hq, S, D], m and l [B, Hq, S], all float32, the mergeable form
//   of ops/attention.py partial_attention.  A row that sees no key (a dead
//   block, or rows above the diagonal of a partly live one) emits the
//   identity (acc = 0, m = NEG_BIG, l = 0).  The TPU kernel carries no
//   band, so the JAX package runs windowed ring steps through its plain
//   path; this kernel takes the window as the forward does, so that no
//   ring step on the card runs the plain version.  The function computed
//   is the same.
//
// Liveness is decided in global coordinates, where the last live kv tile
// of a block, (q_offset + q0 + 63 - kv_offset) / 64, can be negative: a
// block whose rows all precede the kv shard is tested for that first
// (C's division truncates toward zero and would make it tile 0) and runs
// no tile at all.
//
// Known limit of this first version: the products run on the float32 FMA
// units (register-tiled 4 x 4 and 4 x D/16 per thread), not on the tensor
// cores; a wgmma pipeline is the planned remedy.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid of threads

struct FwdArgs {
  const void *q, *k, *v;
  void* o;                // o (T) or the partial's acc (float32)
  float *row_a, *row_b;   // lse, or the partial's m and l
  int b, hq, hkv, s_len, kv_len, causal, window, q_off, kv_off;
  float sm_scale;
  cudaStream_t stream;
};

// The tile loop of one (batch * q head, q tile) block and its epilogue:
// kPartial selects the ring step's (acc, m, l) over (o, lse).
template <typename T, int D, bool kPartial>
__device__ __forceinline__ void flash_tiles(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, void* __restrict__ o_out,
    float* __restrict__ row_a, float* __restrict__ row_b, int hq, int hkv,
    int s_len, int kv_len, int causal, int window, float sm_scale,
    int q_off, int kv_off) {
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
    // Local index of the last key the block's last row can see.
    const int hi = q_off + q0 + kBQ - 1 - kv_off;
    k_last = hi < 0 ? -1 : min(k_last, hi / kBK);
    if (window > 0)
      k_first = max(q_off + q0 - (window - 1) - kv_off, 0) / kBK;
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
      const int qp = q_off + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = kv_off + k0 + c;
        bool keep = k0 + c < kv_len;
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

  if constexpr (kPartial) {
    float* ob = static_cast<float*>(o_out) + static_cast<size_t>(bh) * s_len * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (q0 + r >= s_len) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ob[static_cast<size_t>(q0 + r) * D + tx + 16 * j] = acc[i][j];
      if (tx == 0) {
        row_a[static_cast<size_t>(bh) * s_len + q0 + r] = m_s[r];
        row_b[static_cast<size_t>(bh) * s_len + q0 + r] = l_s[r];
      }
    }
  } else {
    T* ob = static_cast<T*>(o_out) + static_cast<size_t>(bh) * s_len * D;
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
        row_a[static_cast<size_t>(bh) * s_len + q0 + r] = m_s[r] + logf(l);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int hq, int hkv, int s_len,
                     int kv_len, int causal, int window, float sm_scale) {
  flash_tiles<T, D, false>(q, k, v, o, lse, nullptr, hq, hkv, s_len, kv_len,
                           causal, window, sm_scale, 0, 0);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ acc, float* __restrict__ m,
    float* __restrict__ l, int hq, int hkv, int s_len, int kv_len,
    int causal, int window, float sm_scale, int q_off, int kv_off) {
  flash_tiles<T, D, true>(q, k, v, acc, m, l, hq, hkv, s_len, kv_len, causal,
                          window, sm_scale, q_off, kv_off);
}

template <typename T, int D, bool kPartial>
int launch(const FwdArgs& a) {
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D +
                                       kBQ * (kBK + 1) + 3 * kBQ);
  dim3 grid((a.s_len + kBQ - 1) / kBQ, a.b * a.hq);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  if constexpr (kPartial) {
    auto kernel = flash_partial_kernel<T, D>;
    sw_allow_smem(kernel, smem);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, static_cast<float*>(a.o), a.row_a, a.row_b, a.hq, a.hkv,
        a.s_len, a.kv_len, a.causal, a.window, a.sm_scale, a.q_off,
        a.kv_off);
  } else {
    auto kernel = flash_fwd_kernel<T, D>;
    sw_allow_smem(kernel, smem);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, static_cast<T*>(a.o), a.row_a, a.hq, a.hkv, a.s_len,
        a.kv_len, a.causal, a.window, a.sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPartial>
int dispatch(const FwdArgs& a, int d) {
  switch (d) {
    case 16:
      return launch<T, 16, kPartial>(a);
    case 32:
      return launch<T, 32, kPartial>(a);
    case 64:
      return launch<T, 64, kPartial>(a);
    case 128:
      return launch<T, 128, kPartial>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kPartial>
int run(const FwdArgs& a, int d, int is_bf16) {
  return is_bf16 ? dispatch<__nv_bfloat16, kPartial>(a, d)
                 : dispatch<float, kPartial>(a, d);
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
  const FwdArgs a{q, k, v, o, static_cast<float*>(lse), nullptr, b, hq, hkv,
                  s_len, kv_len, causal, window, 0, 0, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return run<false>(a, d, is_bf16);
}

// One ring step: q [B, Hq, S, D] at global position q_off against k/v
// [B, Hkv, Skv, D] at kv_off; writes acc [B, Hq, S, D], m and l [B, Hq, S],
// all float32.  Otherwise as sw_flash_fwd.
extern "C" int sw_flash_partial(const void* q, const void* k, const void* v,
                                void* acc, void* m, void* l, int b, int hq,
                                int hkv, int s_len, int kv_len, int d,
                                int causal, int window, int q_off,
                                int kv_off, float sm_scale, int is_bf16,
                                void* stream) {
  const FwdArgs a{q, k, v, acc, static_cast<float*>(m),
                  static_cast<float*>(l), b, hq, hkv, s_len, kv_len, causal,
                  window, q_off, kv_off, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return run<true>(a, d, is_bf16);
}
