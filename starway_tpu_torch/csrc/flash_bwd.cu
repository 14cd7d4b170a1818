// GQA flash-attention backward: two passes, causal or not, ragged S and
// Skv, sliding window, global [q_offset, kv_offset] coordinates.
//
// Replaces the TPU kernels starway_tpu/ops/pallas_attention.py
// _bwd_dkv_kernel (pass A) and _bwd_dq_kernel (pass B), with _bwd_block's
// recompute (driven there by _run_bwd_passes / _bwd_impl), and the ring
// step's flash_partial_bwd, which runs the same two passes at ring offsets
// and writes float32.
//
// Both passes recompute, per [64 q x 64 k] tile,
//   s = q k^T * sm_scale (masked),  p = exp(s - lse),
//   dp = dO v^T,  ds = p * (dp - delta),
// from the forward's saved row log-sum-exp ``lse`` and
// ``delta = rowsum(dO * O)`` (computed outside, as the JAX package does).
// A masked entry gets p = 0 (lse is finite for every real row), and a q row
// or key past the end of the arrays is masked by a bounds check instead of
// padding.  Rounding points are the TPU kernel's: p is rounded to dO's
// dtype before p^T dO, and ds to q's / k's dtype before each product with
// them; everything else is float32.
//
// Pass A (kv-stationary): one block per (batch * kv head, 64-key tile).
// The block holds its K and V tiles in shared memory and walks the n_rep
// query heads of its kv head times the live q tiles, accumulating
//   dv += p^T dO,  dk += ds^T q
// in float32 registers, so dk/dv sum the grouped query heads with no
// atomics.  It writes dk * sm_scale and dv in the output type TO.
// Pass B (q-stationary): one block per (batch * q head, 64-row q tile); it
// holds q and dO and walks the live kv tiles, accumulating dq += ds k, and
// writes dq * sm_scale.  Both passes are deterministic.
//
// The output type TO is the input dtype T for plain attention and float32
// for a ring step (flash_partial_bwd), whose n contributions the ring sums
// in float32: rounding each to bf16 first would add n roundings.  The
// internal rounding points follow T either way.
//
// Live tiles follow the TPU kernels' tests: with causal masking a tile is
// dead when every key lies after every query, and with a window also when
// every key has fallen out of every query's window; dead tiles are neither
// read nor computed.
//
// What bounds it: operations.  The two passes do 7 products of
// 2 * D flops per visible (q, k) pair and q head (4 in pass A, 3 in pass
// B) against O(S * D) bytes.  Known limit of this first version: the
// products run on the float32 FMA units (register-tiled 4 x 4 scores and
// 4 x D/16 accumulators per thread), not on the tensor cores.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kSP = kBK + 1;   // padded row of a [q][k] tile
static_assert(kBQ == kBK, "load_tile serves q and kv tiles alike");

// Tile [rows][D] of ``src`` (rows from ``r0``, ``n_rows`` valid) into
// shared memory with row stride D + 1; rows past the end read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n_rows) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * DP + c] =
        r0 + r < n_rows ? sw_to_float(src[static_cast<size_t>(r0) * D + i])
                        : 0.f;
  }
}

// Is key ``kp`` visible from query ``qp`` (global coordinates)?
__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  if (!causal) return true;
  return qp >= kp && (window <= 0 || kp > qp - window);
}

// Is the [kBQ x kBK] tile at global (q_glob, k_glob) live?  The TPU
// kernels' liveness tests (pallas_attention.py _bwd_dkv_kernel and
// _bwd_dq_kernel).
__device__ __forceinline__ bool tile_live(int q_glob, int k_glob, int causal,
                                          int window) {
  if (!causal) return true;
  bool live = q_glob + kBQ - 1 >= k_glob;
  if (window > 0) live = live && k_glob + kBK - 1 > q_glob - window;
  return live;
}

// The shared recompute (_bwd_block) of one tile: q rows ty + 16 i and keys
// tx + 16 j of this thread.  Writes p rounded to T into p_s (when given)
// and ds rounded to T into ds_s, both [kBQ][kSP].
template <typename T, int D>
__device__ __forceinline__ void bwd_block(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* dl_s, float* p_s, float* ds_s, int q0,
    int s_len, int q_glob, int k0, int kv_len, int k_glob, int causal,
    int window, float sm_scale) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
  for (int c = 0; c < D; ++c) {
    float a[4], g[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = q_s[(ty + 16 * i) * DP + c];
      g[i] = do_s[(ty + 16 * i) * DP + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = k_s[(tx + 16 * j) * DP + c];
      bv[j] = v_s[(tx + 16 * j) * DP + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
        dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool row_ok = q0 + r < s_len;
    const float lse = lse_s[r];
    const float delta = dl_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool keep = row_ok && k0 + c < kv_len &&
                        visible(q_glob + r, k_glob + c, causal, window);
      const float p = keep ? expf(sc[i][j] * sm_scale - lse) : 0.f;
      if (p_s != nullptr) p_s[r * kSP + c] = sw_round_to<T>(p);
      ds_s[r * kSP + c] = sw_round_to<T>(p * (dp[i][j] - delta));
    }
  }
}

// Row statistics of one q tile into shared memory (0 past the end).
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          const float* lse, const float* dl,
                                          int q0, int s_len) {
  if (threadIdx.x < kBQ) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < s_len ? lse[r] : 0.f;
    dl_s[threadIdx.x] = r < s_len ? dl[r] : 0.f;
  }
}

// Four [64][D + 1] tiles, ``n_sq`` [64][kSP] tiles and two rows.
template <int D>
constexpr size_t smem_bytes(int n_sq) {
  return sizeof(float) * (4 * kBQ * (D + 1) + n_sq * kBQ * kSP + 2 * kBQ);
}

// Pass A: dK, dV.  Grid (kv tiles, B * Hkv).
template <typename T, typename TO, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dk, TO* __restrict__ dv,
    int hq, int hkv, int s_len, int kv_len, int causal, int window,
    float sm_scale, int q_off, int kv_off) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;               // [kBK][D + 1]
  float* v_s = k_s + kBK * DP;     // [kBK][D + 1]
  float* q_s = v_s + kBK * DP;     // [kBQ][D + 1]
  float* do_s = q_s + kBQ * DP;    // [kBQ][D + 1]
  float* p_s = do_s + kBQ * DP;    // [kBQ][kSP]
  float* ds_s = p_s + kBQ * kSP;   // [kBQ][kSP]
  float* lse_s = ds_s + kBQ * kSP;  // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBK;
  const int bkv = blockIdx.y;
  const int b = bkv / hkv;
  const int n_rep = hq / hkv;
  const int head0 = b * hq + (bkv - b * hkv) * n_rep;  // first q head
  const int k_glob = kv_off + k0;
  load_tile<T, D>(k_s, k + static_cast<size_t>(bkv) * kv_len * D, k0, kv_len);
  load_tile<T, D>(v_s, v + static_cast<size_t>(bkv) * kv_len * D, k0, kv_len);

  float acc_k[4][NJ], acc_v[4][NJ];  // key rows ty + 16 i, cols tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_q = (s_len + kBQ - 1) / kBQ;
  for (int rep = 0; rep < n_rep; ++rep) {
    const size_t bh = head0 + rep;
    const T* qb = q + bh * s_len * D;
    const T* dob = dout + bh * s_len * D;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * kBQ;
      if (!tile_live(q_off + q0, k_glob, causal, window)) continue;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(q_s, qb, q0, s_len);
      load_tile<T, D>(do_s, dob, q0, s_len);
      load_rows(lse_s, dl_s, lse + bh * s_len, delta + bh * s_len, q0, s_len);
      __syncthreads();
      bwd_block<T, D>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, q0, s_len,
                      q_off + q0, k0, kv_len, k_glob, causal, window,
                      sm_scale);
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = p_s[r * kSP + ty + 16 * i];
          ds[i] = ds_s[r * kSP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float g = do_s[r * DP + tx + 16 * j];
          const float x = q_s[r * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][j] = fmaf(p[i], g, acc_v[i][j]);
            acc_k[i][j] = fmaf(ds[i], x, acc_k[i][j]);
          }
        }
      }
    }
  }

  const size_t base = static_cast<size_t>(bkv) * kv_len * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= kv_len) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t off = base + static_cast<size_t>(key) * D + tx + 16 * j;
      dk[off] = sw_from_float<TO>(acc_k[i][j] * sm_scale);
      dv[off] = sw_from_float<TO>(acc_v[i][j]);
    }
  }
}

// Pass B: dQ.  Grid (q tiles, B * Hq).
template <typename T, typename TO, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dq, int hq, int hkv,
    int s_len, int kv_len, int causal, int window, float sm_scale, int q_off,
    int kv_off) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;               // [kBK][D + 1]
  float* v_s = k_s + kBK * DP;     // [kBK][D + 1]
  float* q_s = v_s + kBK * DP;     // [kBQ][D + 1]
  float* do_s = q_s + kBQ * DP;    // [kBQ][D + 1]
  float* ds_s = do_s + kBQ * DP;   // [kBQ][kSP]
  float* lse_s = ds_s + kBQ * kSP;  // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const int b = static_cast<int>(bh) / hq;
  const int kvh = b * hkv + (static_cast<int>(bh) - b * hq) / (hq / hkv);
  const T* kb = k + static_cast<size_t>(kvh) * kv_len * D;
  const T* vb = v + static_cast<size_t>(kvh) * kv_len * D;
  const int q_glob = q_off + q0;
  load_tile<T, D>(q_s, q + bh * s_len * D, q0, s_len);
  load_tile<T, D>(do_s, dout + bh * s_len * D, q0, s_len);
  load_rows(lse_s, dl_s, lse + bh * s_len, delta + bh * s_len, q0, s_len);

  float acc[4][NJ];  // q rows ty + 16 i, cols tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_k = (kv_len + kBK - 1) / kBK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBK;
    if (!tile_live(q_glob, kv_off + k0, causal, window)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, kb, k0, kv_len);
    load_tile<T, D>(v_s, vb, k0, kv_len);
    __syncthreads();
    bwd_block<T, D>(q_s, do_s, k_s, v_s, lse_s, dl_s, nullptr, ds_s, q0,
                    s_len, q_glob, k0, kv_len, kv_off + k0, causal, window,
                    sm_scale);
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = ds_s[(ty + 16 * i) * kSP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = k_s[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], x, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s_len) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dq[bh * s_len * D + static_cast<size_t>(r) * D + tx + 16 * j] =
          sw_from_float<TO>(acc[i][j] * sm_scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int b, hq, hkv, s_len, kv_len, causal, window, q_off, kv_off;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename TO, int D>
int launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<T, TO, D>;
  const size_t smem = smem_bytes<D>(2);
  sw_allow_smem(kernel, smem);
  dim3 grid((a.kv_len + kBK - 1) / kBK, a.b * a.hkv);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<TO*>(a.dk), static_cast<TO*>(a.dv), a.hq, a.hkv, a.s_len,
      a.kv_len, a.causal, a.window, a.sm_scale, a.q_off, a.kv_off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO, int D>
int launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<T, TO, D>;
  const size_t smem = smem_bytes<D>(1);
  sw_allow_smem(kernel, smem);
  dim3 grid((a.s_len + kBQ - 1) / kBQ, a.b * a.hq);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<TO*>(a.dq), a.hq, a.hkv, a.s_len, a.kv_len, a.causal,
      a.window, a.sm_scale, a.q_off, a.kv_off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO, bool kDkv>
int dispatch(const Args& a, int d) {
  switch (d) {
    case 16:
      return kDkv ? launch_dkv<T, TO, 16>(a) : launch_dq<T, TO, 16>(a);
    case 32:
      return kDkv ? launch_dkv<T, TO, 32>(a) : launch_dq<T, TO, 32>(a);
    case 64:
      return kDkv ? launch_dkv<T, TO, 64>(a) : launch_dq<T, TO, 64>(a);
    case 128:
      return kDkv ? launch_dkv<T, TO, 128>(a) : launch_dq<T, TO, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Output type: the input's, or float32 when ``out_f32`` (a ring step).
template <bool kDkv>
int run(const Args& a, int d, int out_f32, int is_bf16) {
  if (!is_bf16) return dispatch<float, float, kDkv>(a, d);
  return out_f32 ? dispatch<__nv_bfloat16, float, kDkv>(a, d)
                 : dispatch<__nv_bfloat16, __nv_bfloat16, kDkv>(a, d);
}

}  // namespace

// Pass A.  q/dout [B, Hq, S, D], k/v [B, Hkv, Skv, D], lse/delta [B, Hq, S]
// float32; writes dk/dv [B, Hkv, Skv, D] in the input dtype, or in float32
// when out_f32.  D in {16, 32, 64, 128}; window 0 for none; q_off/kv_off
// are the global positions of row 0 of q and of k.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported D).
extern "C" int sw_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int b,
                                int hq, int hkv, int s_len, int kv_len, int d,
                                int causal, int window, int q_off, int kv_off,
                                float sm_scale, int out_f32, int is_bf16,
                                void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, b, hq, hkv, s_len,
               kv_len, causal, window, q_off, kv_off, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, d, out_f32, is_bf16);
}

// Pass B.  Same inputs as pass A; writes dq [B, Hq, S, D].
extern "C" int sw_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int b, int hq,
                               int hkv, int s_len, int kv_len, int d,
                               int causal, int window, int q_off, int kv_off,
                               float sm_scale, int out_f32, int is_bf16,
                               void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, b, hq, hkv,
               s_len, kv_len, causal, window, q_off, kv_off, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, d, out_f32, is_bf16);
}
