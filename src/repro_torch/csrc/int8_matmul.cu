// Weight-only int8 matmul C = X @ (Wq * scale) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py: int8_matmul
// (_kernel). Same function: int8 weights are converted on chip, the
// product accumulates in fp32 over K, and the per-output-channel fp32
// scale is applied once, when the output tile is written. Activations
// stay float (fp32 or bf16 in, the same type out).
//
// What bounds it on this card: at decode (M = batch = 4) the weights
// dominate the bytes and each weight byte feeds 2 * M FLOPs, so the
// call is bound by bytes; at prefill (M = B * T = 2048) each weight is
// reused M times and the call is bound by operations. The products stay
// IEEE fp32 (no TF32), so both run on the CUDA cores here.
//
// Design: two paths behind one entry point.
// - M > SMALL_M: a shared-memory tiled product, 64 x 64 output tile per
//   block of 256 threads, 4 x 4 outputs per thread, K in steps of 16
//   (the TPU's sequential K grid axis becomes this loop).
// - M <= SMALL_M: a weight-streaming path for decode. A block owns 64
//   output columns; its 8 warps split K, each lane streams 2 adjacent
//   columns (coalesced 64-byte rows of int8) against x rows read as
//   broadcasts, and the 8 partial sums are added in a fixed order, so
//   the result does not depend on scheduling.
// Both read x through its row stride and mask the ragged edges of M, N
// and K here, so the wrapper does not pad.
// Later work: bf16 inputs on wgmma with int8 -> bf16 conversion in
// registers, and TMA-fed pipelines for the weight stream.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TM = 64, TN = 64, TK = 16, TILE_THREADS = 256;
constexpr int SMALL_M = 8;
constexpr int GEMV_WARPS = 8, GEMV_COLS = 64;

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
int8_matmul_tiled(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, T* __restrict__ out,
                  int M, int N, int K, long long lda) {
  __shared__ float as[TK][TM + 4];  // x tile, transposed: as[k][m]
  __shared__ float bs[TK][TN];      // w tile: bs[k][n]
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int u = 0; u < (TM * TK) / TILE_THREADS; ++u) {
      const int idx = tid + u * TILE_THREADS;
      const int m = idx / TK, kk = idx % TK;
      const int gm = row0 + m, gk = k0 + kk;
      as[kk][m] = (gm < M && gk < K) ? to_f32(x[gm * lda + gk]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < (TK * TN) / TILE_THREADS; ++u) {
      const int idx = tid + u * TILE_THREADS;
      const int kk = idx / TN, n = idx % TN;
      const int gk = k0 + kk, gn = col0 + n;
      bs[kk][n] = (gk < K && gn < N)
                      ? static_cast<float>(w[static_cast<long long>(gk) * N + gn])
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = row0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = col0 + tx * 4 + j;
      if (gn < N)
        out[static_cast<long long>(gm) * N + gn] =
            from_f32<T>(acc[i][j] * scale[gn]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
int8_matmul_small_m(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ out,
                    int M, int N, int K, long long lda) {
  __shared__ float part[GEMV_WARPS][SMALL_M][GEMV_COLS];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * GEMV_COLS;
  const int c = col0 + 2 * lane;  // this lane's two columns: c, c + 1
  const int chunk = (K + GEMV_WARPS - 1) / GEMV_WARPS;
  const int kb = warp * chunk;
  const int ke = min(K, kb + chunk);

  float acc[SMALL_M][2];
#pragma unroll
  for (int m = 0; m < SMALL_M; ++m) acc[m][0] = acc[m][1] = 0.0f;

#pragma unroll 4
  for (int k = kb; k < ke; ++k) {
    const int8_t* wr = w + static_cast<long long>(k) * N;
    const float w0 = c < N ? static_cast<float>(wr[c]) : 0.0f;
    const float w1 = c + 1 < N ? static_cast<float>(wr[c + 1]) : 0.0f;
#pragma unroll
    for (int m = 0; m < SMALL_M; ++m) {
      if (m < M) {
        const float xv = to_f32(x[m * lda + k]);
        acc[m][0] = fmaf(xv, w0, acc[m][0]);
        acc[m][1] = fmaf(xv, w1, acc[m][1]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < SMALL_M; ++m) {
    part[warp][m][2 * lane] = acc[m][0];
    part[warp][m][2 * lane + 1] = acc[m][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SMALL_M * GEMV_COLS; i += GEMV_WARPS * 32) {
    const int m = i / GEMV_COLS, n = i % GEMV_COLS;
    const int gn = col0 + n;
    if (m >= M || gn >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < GEMV_WARPS; ++p) s += part[p][m][n];
    out[static_cast<long long>(m) * N + gn] = from_f32<T>(s * scale[gn]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* w, const float* scale,
                   void* out, int M, int N, int K, long long lda,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (M <= SMALL_M) {
    dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS);
    int8_matmul_small_m<T><<<grid, GEMV_WARPS * 32, 0, stream>>>(
        xp, w, scale, op, M, N, K, lda);
  } else {
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    int8_matmul_tiled<T><<<grid, TILE_THREADS, 0, stream>>>(
        xp, w, scale, op, M, N, K, lda);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_matmul_fwd(const void* x, const void* w,
                               const void* scale, void* out, int M, int N,
                               int K, long long lda, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == kFloat32)
    return launch<float>(x, wq, sc, out, M, N, K, lda, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, wq, sc, out, M, N, K, lda, st);
  return cudaErrorInvalidValue;
}
