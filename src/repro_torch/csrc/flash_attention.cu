// Causal prefill attention (flash attention) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_kernel). Same function: an online softmax over key
// tiles with an fp32 accumulator, running max and denominator; GQA (q
// head h reads kv head h / rep); causal, sliding-window
// (pos_k > pos_q - window), softcap (cap * tanh(s / cap)) and per-row
// valid_from (pos_k >= vf[b]) masks; key tiles that every mask rules
// out for the whole block are skipped; a row that never sees an
// attendable key writes zeros. Any head_dim up to 256.
//
// What bounds it on this card: on the CUDA cores, operations (at
// B = 4, T = S = 512, hd = 64, fp32, 1.5 GFLOP over the attended pairs
// of rows of lengths 512, 300, 129 and 37 take 0.023 ms at 67 TFLOP/s).
// On the tensor cores, three TF32 passes take 0.009 ms for that work,
// against 0.012 ms to read the rows of q, k and v from valid_from on
// and write the whole output once; on full rows 0.026 ms against
// 0.020 ms. So the bound is bytes or operations by how many pairs the
// rows attend (chip_smoke.py prints it). Both products run on the
// tensor cores through mma.sync:
// - fp32 inputs: 3xTF32. q * scale (in fp32, as the reference scales),
//   k, p and v are each split into hi = tf32(x) and lo = tf32(x - hi)
//   (x - hi is exact in fp32; hi + lo holds x to about 2^-22 |x|), and
//   each product is lo*hi + hi*lo + hi*hi in m16n8k8 tf32 mma with fp32
//   sums: three passes at 495 TFLOP/s where the CUDA cores' fp32 rate is
//   67. One bf16 pass misses the fp32 tolerance by two orders of
//   magnitude (tests/test_torch_kernels.py emulates both on the CPU).
// - bf16 inputs: m16n8k16 bf16 mma. Q K^T is one pass: q is used as
//   given and `scale` multiplies s in fp32 after the product (q * scale
//   is not exact in bf16). P * V keeps p in fp32, as the TPU kernel
//   (which casts v to fp32 first) and the plain version do: p is split
//   into bf16 hi + lo and both parts multiply the exact bf16 v, two
//   passes. One pass on p rounded to bf16 errs about 2^-9 of the output
//   before its own bf16 rounding (tests/test_torch_kernels.py emulates
//   both on the CPU).
// Each key tile's P * V goes into fresh fp32 fragments that are added to
// the running accumulator on the CUDA cores (acc = acc * corr + pv), so
// the tensor cores' own accumulation spans one tile of keys, not all S.
// (bf16 at hd = 256 rescales acc and lets the mma accumulate into it:
// registers, below.)
//
// Design: a block owns BQ = 64 query rows of one (batch, head) as 4
// warps of 16 rows. Its q tile is loaded once. Key and value tiles of BK
// keys (32 for hd <= 128, 16 for hd <= 256) come
// through a 2-stage ring of 16-byte cp.async copies with zero-fill past
// S and past hd (head dims are padded to 32, 64, 128 or 256 in shared
// memory), so the next tile loads while the current one is multiplied;
// one block barrier a tile. Rows that are not 16-byte aligned (a base
// pointer or a stride, e.g. bf16 at hd = 20, 40 bytes a row) take a
// variant that fills the tiles by element loads. Masks are applied on
// the S fragments; the block visits only the run of key tiles that some
// row of it may attend (the TPU kernel's pl.when, uniform over the
// block), and a warp passes over a tile that masks out all its 16 rows
// (its output stays bit for bit what visiting it gives). The grid's
// slowest axis is the q tile, reversed, so the causal tiles with the
// most keys start first. q/k/v are read in the model layout
// (B, T, H, hd) through strides and the ragged tail of T and S is
// masked here, so the wrapper neither transposes nor pads. No atomics
// and no split over keys: two calls give the same bits.
//
// What made it hard, and what the design does about it:
// - TF32 fragments and ldmatrix. ldmatrix moves b16 elements; one of
//   its 8 x 8 b16 matrices is an 8 x 4 tile of 32-bit words, which is
//   exactly the tf32 A fragment's layout for q and the B fragment's for
//   K^T (K's rows are B's columns, so no transpose). It cannot transpose
//   32-bit elements, so V's B fragment is read with plain 32-bit shared
//   loads; rows are padded by 16 bytes (pitch = 4 mod 32 words), which
//   keeps both those loads and ldmatrix free of bank conflicts.
// - The C -> A handoff of p. In m16n8k8 tf32 the S accumulator of a
//   thread holds key columns (2t, 2t + 1) of an 8-key tile, where the A
//   fragment wants k slots (t, t + 4). The keys of each 8-key group are
//   permuted instead of the registers: slot t stands for key 2t and slot
//   t + 4 for key 2t + 1, so V's B fragment reads rows 2t and 2t + 1. In
//   bf16 m16n8k16 the accumulators of two 8-key tiles are the A fragment
//   of 16 keys as they are (the usual flash-2 reuse).
// - Shared memory above 48 KB (fp32 hd = 64: the q tile and 2 stages of
//   K and V take 52 KB; hd = 256: 133 KB): the launcher opts in once per
//   kernel and device through cudaFuncSetAttribute.
// - Registers at hd = 256: the accumulator alone is 16 * 256 / 32 = 128
//   fp32 a thread. q stays in shared memory (its fragments are loaded,
//   scaled and split for each key tile), BK drops to 16, and P * V walks
//   the head dim in 8-column tiles with one fresh 4-register pv each.
//   bf16 also holds p's two parts: there P * V accumulates into the
//   rescaled acc, and the tile loader reads its thread index through an
//   asm so that the copies' addresses are not kept live across the key
//   loop. With both, no variant spills; chip_smoke.py's build phase
//   fails on any spill.
// - Shared PTX helpers: cp.async, ldmatrix and bf16 mma.sync live in
//   common.cuh, one copy for this kernel and int8_matmul.
// Later work: wgmma on a TMA ring, K and V split once per tile instead
// of once per warp, a key-axis split for long S at small B * H.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;              // query rows a block
constexpr int WARPS = BQ / 16;      // 16 rows a warp
constexpr int THREADS = 32 * WARPS;

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

// Shared-memory layout for input type T at padded head dim HD: the q tile
// [BQ][LD], then 2 stages of K [BK][LD] and V [BK][LD]. Rows are padded
// by 16 bytes (see the note above).
template <typename T, int HD>
struct FlashSmem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // Keys a tile: 32 up to hd 128 (64 keys take 255 registers at fp32
  // hd 64 and were slower on the H100), 16 at hd 256.
  static constexpr int BK = HD <= 128 ? 32 : 16;
  static constexpr int LD = HD + 16 / static_cast<int>(sizeof(T));
  static constexpr int ROW = LD * static_cast<int>(sizeof(T));
  static constexpr int KV_TILE = BK * ROW;
  static constexpr int STAGE = 2 * KV_TILE;
  static constexpr int Q = BQ * ROW;
  static constexpr int BYTES = Q + 2 * STAGE;
  // Blocks an SM should hold (caps the registers a thread at
  // 65536 / (128 * blocks)).
  static constexpr int MIN_BLOCKS = HD <= 128 ? 2 : 1;
};

// The tf32 bits of x, rounded to nearest (ties away from zero).
__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// d += a * b on one 16 x 8 x 8 tile: tf32 operands, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, both split: lo*hi + hi*lo + hi*hi, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Rows [r0, r0 + ROWS) of one head, rows `ld_src` elements apart, into
// the tile [ROWS][LD] at dst; zeros past row L and past column hd (to
// HD). VEC: 16-byte cp.async copies (rows 16-byte aligned); else element
// loads, stored as they arrive.
template <typename T, int HD, int ROWS, bool VEC>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long ld_src, int r0, int L,
                                          int hd) {
  constexpr int LD = FlashSmem<T, HD>::LD;
  if constexpr (VEC) {
    constexpr int EV = 16 / static_cast<int>(sizeof(T));  // elements a copy
    constexpr int CPR = HD / EV;                          // copies a row
    // bf16 at hd 256: the thread index comes from an asm the compiler
    // cannot hoist, so it does not keep each copy's address live across
    // the key loop in registers the accumulator needs (ptxas spilled
    // there; a rolled loop instead was slower).
    unsigned tid = threadIdx.x;
    if constexpr (HD >= 256 && sizeof(T) == 2)
      asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
#pragma unroll
    for (int i = 0; i < (ROWS * CPR + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (ROWS * CPR % THREADS != 0 && c >= ROWS * CPR) break;
      const int r = c / CPR, d = c % CPR * EV;
      const int gr = r0 + r;
      const int n = gr < L ? max(0, min(EV, hd - d)) : 0;
      cp_async16(dst + r * LD + d, n > 0 ? src + gr * ld_src + d : src,
                 n * static_cast<int>(sizeof(T)));
    }
  } else {
    // Raw bits (fp32 or bf16), so a zero is a zero of either type.
    using Bits = std::conditional_t<sizeof(T) == 4, unsigned, unsigned short>;
    const Bits* sb = reinterpret_cast<const Bits*>(src);
    Bits* db = reinterpret_cast<Bits*>(dst);
    static_assert(ROWS * HD % THREADS == 0, "whole rounds of elements");
#pragma unroll 4
    for (int i = 0; i < ROWS * HD / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / HD, d = e % HD;
      const int gr = r0 + r;
      db[r * LD + d] = gr < L && d < hd ? sb[gr * ld_src + d] : Bits(0);
    }
  }
}

// s = (q * scale) K^T for the warp's 16 rows and the tile's BK keys,
// 3xTF32. Accumulator e of key tile j: row g (+ 8 for e >= 2), key
// 8j + 2t + e % 2.
template <int HD>
__device__ __forceinline__ void qk_f32(const float* qs, const float* ks,
                                       float (&s)[FlashSmem<float, HD>::BK / 8]
                                                 [4],
                                       float scale, int warp, int lane) {
  using S = FlashSmem<float, HD>;
  constexpr int NT = S::BK / 8;
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc) {
    // Matrices: rows 0-7 and 8-15 at columns 0-3, then at columns 4-7:
    // the A fragment a0..a3.
    unsigned a[4], ah[4], al[4];
    ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * S::LD + kc * 8 +
                       (lane >> 4) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(__uint_as_float(a[i]) * scale, ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      // Matrices: keys of tile j at columns 0-3 and 4-7 (b0, b1), then
      // those of tile j + 1.
      unsigned b[4], bh[4], bl[4];
      ldmatrix_x4(b, ks + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * S::LD +
                         kc * 8 + ((lane >> 3) & 1) * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(__uint_as_float(b[i]), bh[i], bl[i]);
      mma_3xtf32(s[j], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma_3xtf32(s[j + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// s = (q K^T) * scale, one bf16 pass; the same accumulator layout.
template <int HD>
__device__ __forceinline__ void qk_bf16(
    const __nv_bfloat16* qs, const __nv_bfloat16* ks,
    float (&s)[FlashSmem<__nv_bfloat16, HD>::BK / 8][4], float scale,
    int warp, int lane) {
  using S = FlashSmem<__nv_bfloat16, HD>;
  constexpr int NT = S::BK / 8;
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    // Matrices: rows 0-7 and 8-15 at k 0-7, then at k 8-15.
    unsigned a[4];
    ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * S::LD + kc * 16 +
                       (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      // Matrices: keys of tile j at k 0-7 and 8-15, then of tile j + 1.
      unsigned b[4];
      ldmatrix_x4(b, ks + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * S::LD +
                         kc * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale;
}

// acc = acc * corr + p V for the warp's rows, 3xTF32. p's A fragment of
// key tile j is its S accumulator with the keys permuted: slot t is key
// 2t (a0 = s0, a1 = s2), slot t + 4 is key 2t + 1 (a2 = s1, a3 = s3),
// so V's B fragment takes rows 2t and 2t + 1 of the tile.
template <int HD>
__device__ __forceinline__ void pv_f32(const float* vs,
                                       const float (&p)[FlashSmem<float, HD>::BK
                                                        / 8][4],
                                       float (&acc)[HD / 8][4],
                                       const float (&corr)[2], int lane) {
  using S = FlashSmem<float, HD>;
  constexpr int NT = S::BK / 8;
  const int g = lane >> 2, t = lane & 3;
  unsigned ph[NT][4], pl[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(p[j][0], ph[j][0], pl[j][0]);
    split_tf32(p[j][2], ph[j][1], pl[j][1]);
    split_tf32(p[j][1], ph[j][2], pl[j][2]);
    split_tf32(p[j][3], ph[j][3], pl[j][3]);
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* vr = vs + (j * 8 + 2 * t) * S::LD + n * 8 + g;
      unsigned bh0, bl0, bh1, bl1;
      split_tf32(vr[0], bh0, bl0);
      split_tf32(vr[S::LD], bh1, bl1);
      mma_3xtf32(pv, ph[j], pl[j], bh0, bh1, bl0, bl1);
    }
    acc[n][0] = acc[n][0] * corr[0] + pv[0];
    acc[n][1] = acc[n][1] * corr[0] + pv[1];
    acc[n][2] = acc[n][2] * corr[1] + pv[2];
    acc[n][3] = acc[n][3] * corr[1] + pv[3];
  }
}

// The same on bf16 v: p stays fp32, as the reference multiplies fp32 p
// by v in fp32, so it is split into bf16 parts p = hi + lo (to about
// 2^-17 |p|) and each part multiplies the exact bf16 v: lo * v + hi * v.
// The accumulators of key tiles 2kk and 2kk + 1 are the A fragment of 16
// keys; V's B fragment comes from ldmatrix.trans of the key-major tile.
template <int HD>
__device__ __forceinline__ void pv_bf16(
    const __nv_bfloat16* vs,
    const float (&p)[FlashSmem<__nv_bfloat16, HD>::BK / 8][4],
    float (&acc)[HD / 8][4], const float (&corr)[2], int lane) {
  using S = FlashSmem<__nv_bfloat16, HD>;
  constexpr int NT = S::BK / 8;
  unsigned ph[NT / 2][4], pl[NT / 2][4];
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a0, a1: rows g, g + 8 of keys 0-7; a2, a3: of keys 8-15.
      const float* pr = p[2 * kk + (i >> 1)] + (i & 1) * 2;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(pr[0], pr[1]);
      ph[kk][i] = bf16x2_bits(hi);
      pl[kk][i] = bf16x2_bits(__floats2bfloat162_rn(
          pr[0] - __low2float(hi), pr[1] - __high2float(hi)));
    }
  // Two column tiles an iteration, from one ldmatrix.x4. Up to hd 128
  // each tile's P V goes into fresh fragments added to the rescaled
  // accumulator. At hd 256 the accumulator takes 128 registers, and every
  // form of fresh fragments tried spilled (ptxas: 255 registers and
  // 288-336 bytes of spill stores, where this form takes 227-236 and
  // none): acc is rescaled first and the mma accumulates into it. Its
  // own fp32 accumulation then spans all S keys, not one tile: about one
  // fp32 rounding of acc a key tile, some 2^-18 of it after the 32 tiles
  // of S = 512, far below the bf16 output's own 2^-9. The in-place form
  // at hd 64 and 128 agreed as closely but was 1-2% slower on the H100,
  // so those keep fresh fragments.
  constexpr bool IN_PLACE = HD >= 256;
#pragma unroll
  for (int n = 0; n < HD / 8; n += 2) {
    float pv[2][4] = {};
    if constexpr (IN_PLACE) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n + u][e] *= corr[e >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      // Matrices: keys 0-7 and 8-15 of column tile n, then of n + 1.
      unsigned b[4];
      ldmatrix_x4_trans(
          b, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::LD +
                 (n + (lane >> 4)) * 8);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        mma_bf16(IN_PLACE ? acc[n + u] : pv[u], pl[kk], b[2 * u],
                 b[2 * u + 1]);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        mma_bf16(IN_PLACE ? acc[n + u] : pv[u], ph[kk], b[2 * u],
                 b[2 * u + 1]);
    }
    if constexpr (!IN_PLACE) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        acc[n + u][0] = acc[n + u][0] * corr[0] + pv[u][0];
        acc[n + u][1] = acc[n + u][1] * corr[0] + pv[u][1];
        acc[n + u][2] = acc[n + u][2] * corr[1] + pv[u][2];
        acc[n + u][3] = acc[n + u][3] * corr[1] + pv[u][3];
      }
    }
  }
}

// Whether a key tile starting at k0 holds a key that some row of the
// block [q0, q0 + BQ) may attend: valid_from, causal, window.
__device__ __forceinline__ bool tile_runs(int k0, int bk, int q0, int vf,
                                          int window) {
  bool run = k0 + bk - 1 >= vf && k0 <= q0 + BQ - 1;
  if (window) run = run && k0 + bk - 1 > q0 - window;
  return run;
}

// Block (h, b, z) computes rows [q0, q0 + BQ) of head h of batch row b,
// where q tile (gridDim.z - 1 - z) is q0 / BQ.
template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(THREADS, (FlashSmem<T, HD>::MIN_BLOCKS))
flash_attention_kernel(FlashArgs a) {
  using S = FlashSmem<T, HD>;
  constexpr int BK = S::BK;
  constexpr int NT = BK / 8;   // 8-key tiles of s
  constexpr int DT = HD / 8;   // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* qs = reinterpret_cast<T*>(fa_smem);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = h / (a.Hq / a.KV);
  const int vf = a.vf[b];
  const int rw0 = q0 + warp * 16;   // the warp's rows: rw0 .. rw0 + 15

  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  // The tiles that pass tile_runs form one run [kt0, kt1).
  const int ntiles = (a.S + BK - 1) / BK;
  int kt0 = 0;
  while (kt0 < ntiles && !tile_runs(kt0 * BK, BK, q0, vf, a.window)) ++kt0;
  int kt1 = kt0;
  while (kt1 < ntiles && tile_runs(kt1 * BK, BK, q0, vf, a.window)) ++kt1;

  // The q tile and the first key tile go out as one commit group.
  load_rows<T, HD, BQ, VEC>(qs, qp, a.qst, q0, a.T, a.hd);
  if (kt0 < kt1) {
    T* ks = reinterpret_cast<T*>(fa_smem + S::Q);
    load_rows<T, HD, BK, VEC>(ks, kp, a.kss, kt0 * BK, a.S, a.hd);
    load_rows<T, HD, BK, VEC>(ks + BK * S::LD, vp, a.vss, kt0 * BK, a.S,
                              a.hd);
  }
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // Running max and this thread's share of the denominator of rows
  // rw0 + g and rw0 + g + 8.
  float m_r[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l_r[2] = {0.0f, 0.0f};

  for (int kt = kt0; kt < kt1; ++kt) {
    const int slot = (kt - kt0) & 1;
    // Tile kt has landed for every thread, and every warp is done with
    // tile kt - 1: its slot is free for tile kt + 1.
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kt1) {
      T* ks = reinterpret_cast<T*>(fa_smem + S::Q + (slot ^ 1) * S::STAGE);
      load_rows<T, HD, BK, VEC>(ks, kp, a.kss, (kt + 1) * BK, a.S, a.hd);
      load_rows<T, HD, BK, VEC>(ks + BK * S::LD, vp, a.vss, (kt + 1) * BK,
                                a.S, a.hd);
    }
    cp_async_commit();

    const int k0 = kt * BK;
    // A tile that masks out all 16 rows of this warp changes nothing
    // that visiting it would not: p = 0 and corr = 1 once a row has seen
    // a key; before that, corr = 0 wipes it on the first key seen.
    if (k0 > rw0 + 15 || (a.window && k0 + BK - 1 <= rw0 - a.window))
      continue;
    const T* ks = reinterpret_cast<const T*>(fa_smem + S::Q + slot * S::STAGE);
    const T* vs = ks + BK * S::LD;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    if constexpr (S::F32)
      qk_f32<HD>(qs, ks, s, a.scale, warp, lane);
    else
      qk_bf16<HD>(qs, ks, s, a.scale, warp, lane);

    // Softcap, then the masks; a tile that no mask touches for any row
    // of the warp skips the mask.
    const bool full = k0 >= vf && k0 + BK <= a.S && k0 + BK - 1 <= rw0 &&
                      (!a.window || k0 > rw0 + 15 - a.window);
    float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap_f32(s[j][e], a.cap);
        if (!full) {
          const int row = rw0 + g + (e >> 1) * 8;
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          bool ok = key >= vf && key < a.S && key <= row;
          if (a.window) ok = ok && key > row - a.window;
          x = ok ? x : REPRO_NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // Rows are spread over the 4 threads of a quad (lanes 4g .. 4g + 3).
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_r[e >> 1]);
        ps[e >> 1] += s[j][e];
      }
    l_r[0] = l_r[0] * corr[0] + ps[0];
    l_r[1] = l_r[1] * corr[1] + ps[1];
    if constexpr (S::F32)
      pv_f32<HD>(vs, s, acc, corr, lane);
    else
      pv_bf16<HD>(vs, s, acc, corr, lane);
  }
  cp_async_wait<0>();  // nothing left in flight at exit

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = rw0 + g + 8 * r;
    if (row >= a.T) continue;
    // m still at NEG_INF <=> the row never saw an attendable key.
    const bool seen = m_r[r] > REPRO_NEG_INF * 0.5f;
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    // Output in the model layout (B, T, Hq, hd), contiguous.
    const long long base =
        ((static_cast<long long>(b) * a.T + row) * a.Hq + h) * a.hd;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < a.hd)
        op[base + d] = from_f32<T>(seen ? acc[n][2 * r] * inv : 0.0f);
      if (d + 1 < a.hd)
        op[base + d + 1] = from_f32<T>(seen ? acc[n][2 * r + 1] * inv : 0.0f);
    }
  }
}

template <typename T, int HD, bool VEC>
cudaError_t launch_hd(const FlashArgs& a, cudaStream_t stream) {
  constexpr int smem = FlashSmem<T, HD>::BYTES;
  static bool opted_in[64] = {};
  const cudaError_t err =
      smem_opt_in(flash_attention_kernel<T, HD, VEC>, smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hq, a.B, (a.T + BQ - 1) / BQ);
  flash_attention_kernel<T, HD, VEC><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_vec(const FlashArgs& a, cudaStream_t stream) {
  if (a.hd <= 32) return launch_hd<T, 32, VEC>(a, stream);
  if (a.hd <= 64) return launch_hd<T, 64, VEC>(a, stream);
  if (a.hd <= 128) return launch_hd<T, 128, VEC>(a, stream);
  if (a.hd <= 256) return launch_hd<T, 256, VEC>(a, stream);
  return cudaErrorInvalidValue;
}

// 16-byte copies when every row of q, k and v starts 16-byte aligned.
template <typename T>
bool rows_aligned(const FlashArgs& a) {
  const long long strides[9] = {a.qsb, a.qst, a.qsh, a.ksb, a.kss,
                                a.ksh, a.vsb, a.vss, a.vsh};
  for (long long s : strides)
    if (s * static_cast<long long>(sizeof(T)) % 16) return false;
  const void* ptrs[3] = {a.q, a.k, a.v};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <typename T>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.T <= 0 || a.Hq <= 0 || a.KV <= 0 || a.hd <= 0)
    return cudaErrorInvalidValue;
  return rows_aligned<T>(a) ? launch_vec<T, true>(a, stream)
                            : launch_vec<T, false>(a, stream);
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
