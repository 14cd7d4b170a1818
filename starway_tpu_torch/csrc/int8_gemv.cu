// W8A16 matmul: out [M, F] = (x [M, D] @ wq int8 [D, F]) * scale f32 [F].
//
// Replaces the TPU kernel starway_tpu/ops/pallas_gemv.py _gemv_kernel
// (entry int8_matmul).
//
// What bounds it: at decode (M = batch rows, a few to a few dozen) the int8
// weight stream, one byte per parameter per step; at prefill (M = the
// prompt bucket, up to max_len) the multiply-adds.  The design reads wq
// coalesced along F with 16-byte loads, widens it to float32 in shared
// memory, accumulates in float32 registers and applies the per-column
// scale once, after the product, so no wide weight tile exists in device
// memory.  Unlike the TPU kernel, which keeps all of x resident, it tiles M
// as well as F (a prefill sends thousands of rows through here), and it
// masks the ragged edges of M, D and F (the lm_head has F = 128256; an F
// that is not a multiple of 16 falls back to byte loads).
//
// Two tile shapes: 8 x 32 with a 128-deep k step for decode-sized M (many
// blocks over F, several weight loads in flight per thread), and 64 x 64
// with a 4 x 4 register tile per thread above that.
#include "common.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) int8_matmul_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out, int m, int d,
    int f, int vec) {
  constexpr int NX = BN / TN;  // threads along F
  constexpr int NT = (BM / TM) * NX;
  constexpr int VPR = BN / 16;  // 16-byte weight vectors per tile row
  constexpr int NV = BK * VPR;
  constexpr int VITERS = (NV + NT - 1) / NT;
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % NX;
  const int ty = tid / NX;
  const int m0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    if (vec) {
      uint4 buf[VITERS];
#pragma unroll
      for (int it = 0; it < VITERS; ++it) {
        const int c = tid + it * NT;
        const int kk = c / VPR;
        const int gk = k0 + kk, gf = f0 + (c - kk * VPR) * 16;
        buf[it] = make_uint4(0, 0, 0, 0);
        if (c < NV && gk < d && gf < f)
          buf[it] = *reinterpret_cast<const uint4*>(
              w + static_cast<size_t>(gk) * f + gf);
      }
#pragma unroll
      for (int it = 0; it < VITERS; ++it) {
        const int c = tid + it * NT;
        if (c >= NV) break;
        const int kk = c / VPR;
        const int n = (c - kk * VPR) * 16;
        const int8_t* e = reinterpret_cast<const int8_t*>(&buf[it]);
#pragma unroll
        for (int q = 0; q < 16; ++q) ws[kk][n + q] = static_cast<float>(e[q]);
      }
    } else {
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = i / BN;
        const int n = i - kk * BN;
        const int gk = k0 + kk, gf = f0 + n;
        ws[kk][n] = gk < d && gf < f
                        ? static_cast<float>(
                              w[static_cast<size_t>(gk) * f + gf])
                        : 0.f;
      }
    }
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK;
      const int kk = i - r * BK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = gm < m && gk < d
                      ? sw_to_float(x[static_cast<size_t>(gm) * d + gk])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bw[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bw[j] = ws[kk][tx + j * NX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gf = f0 + tx + j * NX;
      if (gf < f)
        out[static_cast<size_t>(gm) * f + gf] =
            sw_from_float<T>(acc[i][j] * scale[gf]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const void* x, const void* w, const void* scale, void* out, int m,
           int d, int f, int vec, cudaStream_t stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM);
  int8_matmul_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(scale), static_cast<T*>(out), m, d, f,
          vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const void* scale, void* out,
             int m, int d, int f, int vec, cudaStream_t st) {
  if (m <= 8)
    return launch<T, 8, 32, 128, 1, 2>(x, w, scale, out, m, d, f, vec, st);
  return launch<T, 64, 64, 32, 4, 4>(x, w, scale, out, m, d, f, vec, st);
}

}  // namespace

// x [M, D] (bfloat16 if is_bf16 else float32), wq int8 [D, F], scale float32
// [F], out [M, F] in x's dtype.  vec: 1 when F % 16 == 0 and wq is 16-byte
// aligned (16-byte weight loads), else 0.  Returns cudaGetLastError() after
// the launch.
extern "C" int sw_int8_matmul(const void* x, const void* wq,
                              const void* scale, void* out, int m, int d,
                              int f, int is_bf16, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, wq, scale, out, m, d, f, vec, st);
  return dispatch<float>(x, wq, scale, out, m, d, f, vec, st);
}
