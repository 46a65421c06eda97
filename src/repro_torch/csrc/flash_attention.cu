// Causal prefill attention (flash attention) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_kernel). Same function: an online softmax over key
// tiles with an fp32 accumulator, running max and denominator; GQA (q
// head h reads kv head h / rep); causal, sliding-window
// (pos_k > pos_q - window), softcap (cap * tanh(s / cap)) and per-row
// valid_from (pos_k >= vf[b]) masks; key tiles that every mask rules
// out for the whole block are skipped; a row that never sees an
// attendable key writes zeros.
//
// What bounds it on this card: at the serving shapes (T = S = 512,
// hd = 64) the work is ~T*S*hd*2 FLOPs per head against ~T*hd*16 bytes,
// so it is bound by operations. fp32 products must stay IEEE fp32 (no
// TF32), which rules out the tensor cores for fp32 inputs; this first
// kernel runs both fp32 and bf16 on the CUDA cores.
//
// Design: one thread owns one query row (q and the accumulator live in
// registers) and a block of BQ rows walks the key axis in tiles of BK
// keys staged in shared memory as fp32. Every thread of a block reads
// the same key/value element at the same time, so the shared-memory
// reads are broadcasts. The TPU grid's sequential key axis becomes the
// loop inside the block; the scalar-prefetched valid_from becomes a
// load by the block itself; q/k/v are read in the model layout
// (B, T, H, hd) through strides, and the ragged tail of T and S is
// masked here, so the wrapper neither transposes nor pads.
// Head dims up to 64 (every ported config): q and the accumulator take
// 2 * HD registers per thread, and at HD = 128 they spill.
// Later work: wgmma on bf16 tiles, TMA loads, a split over the key axis.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block, one per thread
constexpr int BK = 32;  // keys per shared-memory tile

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* vf;
  int B, T, S, Hq, KV, hd;
  long long qsb, qst, qsh;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  float scale, cap;
  int window;
};

template <typename T, int HD>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(FlashArgs a) {
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = q0 + tid;  // this thread's query position
  const int kvh = h / (a.Hq / a.KV);
  const int vf = a.vf[b];

  const T* qp = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  float q[HD];
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    float x = 0.0f;
    if (d < a.hd && row < a.T)
      x = to_f32(qp[b * a.qsb + row * a.qst + h * a.qsh + d]) * a.scale;
    q[d] = x;
    acc[d] = 0.0f;
  }
  float m_i = REPRO_NEG_INF;
  float l_i = 0.0f;

  for (int k0 = 0; k0 < a.S; k0 += BK) {
    // Tile-level skip, uniform over the block (as the TPU kernel's
    // pl.when): below valid_from, above the causal diagonal, or before
    // the window of every row of this block.
    bool run = k0 + BK - 1 >= vf && k0 <= q0 + BQ - 1;
    if (a.window) run = run && (k0 + BK - 1 > q0 - a.window);
    if (!run) continue;

    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * HD; i += BQ) {
      const int j = i / HD;
      const int d = i % HD;
      const int key = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < a.S && d < a.hd) {
        kx = to_f32(kp[b * a.ksb + key * a.kss + kvh * a.ksh + d]);
        vx = to_f32(vp[b * a.vsb + key * a.vss + kvh * a.vsh + d]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    float s[BK];
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(q[d], ks[j][d], dot);
      dot = softcap_f32(dot, a.cap);
      const int pk = k0 + j;
      bool ok = pk >= vf && pk < a.S && pk <= row;
      if (a.window) ok = ok && pk > row - a.window;
      s[j] = ok ? dot : REPRO_NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l_i = l_i * corr + psum;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      float pv = 0.0f;
#pragma unroll
      for (int j = 0; j < BK; ++j) pv = fmaf(s[j], vs[j][d], pv);
      acc[d] = acc[d] * corr + pv;
    }
    m_i = m_new;
  }

  if (row >= a.T) return;
  // m_i still at NEG_INF <=> the row never saw an attendable key.
  const bool seen = m_i > REPRO_NEG_INF * 0.5f;
  const float inv = 1.0f / fmaxf(l_i, 1e-30f);
  T* op = static_cast<T*>(a.o);
  // Output in the model layout (B, T, Hq, hd), contiguous.
  const long long base =
      ((static_cast<long long>(b) * a.T + row) * a.Hq + h) * a.hd;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    if (d < a.hd) op[base + d] = from_f32<T>(seen ? acc[d] * inv : 0.0f);
  }
}

template <typename T>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  dim3 grid((a.T + BQ - 1) / BQ, a.Hq, a.B);
  if (a.hd <= 32) {
    flash_attention_kernel<T, 32><<<grid, BQ, 0, stream>>>(a);
  } else if (a.hd <= 64) {
    flash_attention_kernel<T, 64><<<grid, BQ, 0, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* vf,
    int B, int T, int S, int Hq, int KV, int hd, long long qsb,
    long long qst, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, float scale,
    float cap, int window, int dtype, void* stream) {
  FlashArgs a{q,   k,   v,   o,   vf,  B,   T,   S,     Hq,  KV,     hd,
              qsb, qst, qsh, ksb, kss, ksh, vsb, vss,   vsh, scale,  cap,
              window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(a, st);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}
