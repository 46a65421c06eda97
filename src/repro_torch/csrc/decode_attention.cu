// One-token decode attention against a KV cache, for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (_kernel). Same function: one block covers all
// rep = Hq / KV query heads of one KV group; a cache slot is valid when
// its stored position p satisfies p >= 0, p >= valid_from[b],
// p <= cache_pos and, if windowed, p > cache_pos - window (pos = -1
// marks an unwritten slot, masked explicitly here rather than through
// valid_from >= 0); softcap applies; a row with no valid slot writes
// zeros. With linear = 1 (slot index == stored position) tiles wholly
// below valid_from or wholly past cache_pos are skipped; the skip is
// bit-identical to the full scan, because a fully masked tile leaves the
// running state unchanged once a valid slot was seen, and is wiped by
// the exact-zero rescale (exp(-1e30 - m) == 0) before one was.
//
// What bounds it on this card: each cached key and value is read once
// and used for 2 * rep FLOPs per element, far below the card's
// operations-per-byte ridge, so it is bound by bytes (the K/V cache).
//
// Design: the block stages a tile of BS slots of K and V in shared
// memory with coalesced loads (K rows padded by one float so that one
// thread per slot reads without bank conflicts), scores the tile one
// slot per thread, reduces max and sum per q head with warp shuffles,
// and accumulates p @ V one output element per thread. The TPU grid's
// sequential cache axis becomes the loop inside the block; cache_pos is
// a kernel argument and valid_from / pos are read by the block itself;
// K and V are read in the model layout (B, S, KV, hd) through strides
// and the ragged end of S is masked here, so the wrapper does not pad.
// Later work: split the cache axis over more blocks (B * KV = 128 blocks
// at the serving shapes leave SMs idle) and pipeline the tile loads.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BS = 64;        // cache slots per shared-memory tile
constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  const int* vf;
  void* o;
  int B, S, Hq, KV, hd;
  long long qsb, qsh;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  int cache_pos;
  float scale, cap;
  int window, linear;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd;
  const int rep = a.Hq / a.KV;
  const int ldk = hd + 1;
  float* ks = smem;                  // [BS][hd + 1]
  float* vs = ks + BS * ldk;         // [BS][hd]
  float* qs = vs + BS * hd;          // [rep][hd], pre-scaled
  float* ps = qs + rep * hd;         // [rep][BS] scores, then probs
  float* acc = ps + rep * BS;        // [rep][hd]
  float* m_i = acc + rep * hd;       // [rep]
  float* l_i = m_i + rep;            // [rep]
  float* corr = l_i + rep;           // [rep]

  const int g = blockIdx.x;  // KV head
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int cpos = a.cache_pos;
  const int vf = a.vf[b];

  const T* qp = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  for (int i = tid; i < rep * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    qs[i] = to_f32(qp[b * a.qsb + (g * rep + r) * a.qsh + d]) * a.scale;
    acc[i] = 0.0f;
  }
  for (int r = tid; r < rep; r += THREADS) {
    m_i[r] = REPRO_NEG_INF;
    l_i[r] = 0.0f;
  }

  for (int t0 = 0; t0 < a.S; t0 += BS) {
    if (a.linear && !(t0 + BS - 1 >= vf && t0 <= cpos)) continue;

    __syncthreads();  // previous tile (and the init above) complete
    for (int i = tid; i < BS * hd; i += THREADS) {
      const int j = i / hd, d = i % hd;
      const int slot = t0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (slot < a.S) {
        kx = to_f32(kp[b * a.ksb + slot * a.kss + g * a.ksh + d]);
        vx = to_f32(vp[b * a.vsb + slot * a.vss + g * a.vsh + d]);
      }
      ks[j * ldk + d] = kx;
      vs[j * hd + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < rep * BS; i += THREADS) {
      const int r = i / BS, j = i % BS;
      const int slot = t0 + j;
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d)
        dot = fmaf(qs[r * hd + d], ks[j * ldk + d], dot);
      dot = softcap_f32(dot, a.cap);
      const int p = slot < a.S ? a.pos[slot] : -1;
      bool ok = p >= 0 && p >= vf && p <= cpos;
      if (a.window) ok = ok && p > cpos - a.window;
      ps[i] = ok ? dot : REPRO_NEG_INF;
    }
    __syncthreads();

    // Per q head: tile max, probabilities, tile sum (one warp per head).
    for (int r = warp; r < rep; r += WARPS) {
      float* row = ps + r * BS;
      float mx = REPRO_NEG_INF;
      for (int j = lane; j < BS; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      float sum = 0.0f;
      for (int j = lane; j < BS; j += 32) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = expf(m_i[r] - m_new);
        corr[r] = c;
        l_i[r] = l_i[r] * c + sum;
        m_i[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < rep * hd; i += THREADS) {
      const int r = i / hd, d = i % hd;
      const float* prow = ps + r * BS;
      float pv = 0.0f;
      for (int j = 0; j < BS; ++j) pv = fmaf(prow[j], vs[j * hd + d], pv);
      acc[i] = acc[i] * corr[r] + pv;
    }
  }
  __syncthreads();

  T* op = static_cast<T*>(a.o);  // (B, Hq, hd), contiguous
  for (int i = tid; i < rep * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    const bool seen = m_i[r] > REPRO_NEG_INF * 0.5f;
    const float out = seen ? acc[i] / fmaxf(l_i[r], 1e-30f) : 0.0f;
    op[(static_cast<long long>(b) * a.Hq + g * rep + r) * hd + d] =
        from_f32<T>(out);
  }
}

template <typename T>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const int rep = a.Hq / a.KV;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(BS) * (a.hd + 1) +
                       static_cast<size_t>(BS) * a.hd + 2 * rep * a.hd +
                       rep * BS + 3 * rep);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(a.KV, a.B);
  decode_attention_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* pos,
    const int* vf, void* o, int B, int S, int Hq, int KV, int hd,
    long long qsb, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    int cache_pos, float scale, float cap, int window, int linear,
    int dtype, void* stream) {
  DecodeArgs a{q,   k,   v,   pos, vf,  o,   B,   S,         Hq,
               KV,  hd,  qsb, qsh, ksb, kss, ksh, vsb,       vss,
               vsh, cache_pos, scale, cap, window, linear};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(a, st);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}
