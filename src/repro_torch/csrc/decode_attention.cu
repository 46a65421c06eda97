// One-token decode attention against a KV cache, for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (_kernel). Same function: the rep = Hq / KV query
// heads of one KV group attend the group's cache; a cache slot is valid
// when its stored position p satisfies p >= 0, p >= valid_from[b],
// p <= cache_pos and, if windowed, p > cache_pos - window (pos = -1
// marks an unwritten slot); softcap applies; a row with no valid slot
// writes exact zeros. With linear = 1 (slot index == stored position)
// the slots wholly outside [valid_from[b], cache_pos] are not read.
// cache_pos is one int32 in device memory, as the TPU kernel's
// scalar-prefetch cpos_ref: each block loads it beside valid_from[b], so
// no launch argument holds a position and one captured CUDA graph of a
// decode step serves every position.
//
// What bounds it on this card: each attended cached key and value is
// read once and used for 2 * rep FLOPs per element, far below the card's
// operations-per-byte ridge, so it is bound by bytes: the K and V rows
// it attends (with linear = 1, only those from valid_from[b] to
// cache_pos). Those are few (17 MB at the serving shape, 5 us of HBM),
// so the design is about spreading them over every SM, keeping enough
// 16-byte copies in flight, and a short fixed cost.
//
// Design (flash decoding):
// - Split plan. The cache axis is cut into chunks of one block tile (4
//   warp tiles). The blocks of one (b, KV group) are one thread-block
//   cluster (grid = splits x B * KV, cluster = splits x 1), and block c
//   of it takes chunks c, c + splits, c + 2 splits, ...: whatever
//   [valid_from[b], cache_pos] is, the blocks of a group get shares of
//   it within one chunk of each other (one contiguous share a block
//   would leave all but the first blocks idle at short contexts). The
//   launcher takes
//   as many blocks as S has chunks, at most 16 (a non-portable cluster),
//   then fewer while the card cannot hold every group's cluster at once
//   (cudaOccupancyMaxActiveClusters: one wave). The plan depends on B,
//   KV, S, hd, rep, dtype and the device, never on cache_pos or
//   valid_from: make_plan takes a DecodeShape, which does not hold them.
//   So the linear skip and the full scan see the same partition, and
//   the grid does not change from one decode step to the next.
//   decode_attention_plan reports it.
// - Loads. Warp w of a block takes warp tile w of each of the block's
//   chunks, in order. Lanes split head_dim: LPR lanes hold one row, each
//   lane 16-byte pieces (4 fp32 or 8 bf16) at a stride of LPR pieces, so
//   one warp copy covers 512 contiguous-by-row bytes; a warp tile is 4
//   such pieces of K and 4 of V a lane. Each warp streams its tiles
//   through its own 3-stage cp.async ring in shared memory, lane-major,
//   where each lane copies and later reads back only its own pieces (no
//   block barrier; one __syncwarp for the stored positions, which the
//   row's first lane copies): while a tile is computed the next 3 are in
//   flight. K and V are read in the model layout (B, S, KV, hd) through
//   strides, once, for all rep heads. Rows that are not 16-byte aligned
//   take an element-load variant of the same kernel, which fills the
//   ring by plain loads. With linear = 1 a block or warp tile wholly
//   outside [valid_from[b], cache_pos] starts no load.
// - Arithmetic on the CUDA cores in fp32 (bf16 converts on load; the
//   output rounds once). q * scale sits in shared memory. Per head r
//   and tile: each lane's partial dot of its head_dim slice, summed over
//   the row's LPR lanes by xor shuffles; the tile's max and sum over the
//   warp by shuffles; p = 0 exactly for a masked slot; the accumulator
//   rows in shared memory (per warp and row group, so rep * hd up to
//   16 x 256 fits), rescaled and updated by the lanes that own them.
//   Lane r keeps head r's running max and sum. A tile with no valid slot
//   changes no state (corr = exp(0) = 1, p = 0), so skipping it gives the
//   bits of scanning it.
// - Combine, in a fixed order. Each block folds its warps' (m, l, acc)
//   in warp order; then, after a cluster barrier, each block of the
//   cluster takes a slice of the rep * hd outputs and reads the blocks'
//   partials over DSMEM (mapa / ld.shared::cluster) in rank order. A
//   partial with m <= -0.5e30 (nothing valid) is left out of both folds,
//   not weighted by an exp that underflows, so skipped and scanned
//   blocks give the same bits and a row with nothing valid writes zeros.
//   A second cluster barrier keeps every block's shared memory alive
//   until the reads are done. One launch a call (cudaLaunchKernelEx), no
//   workspace, no atomics: two calls give the same bits.
// Takes head_dim up to 256 (instantiated at 64, 128, 256; smaller ones
// masked) and rep up to 16.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 16;
constexpr int MAX_SPLITS = 16;  // a non-portable cluster
constexpr int MAX_HEAD_DIM = 256;
constexpr int STAGES = 3;      // tiles a warp has in flight
constexpr unsigned FULL = 0xffffffffu;

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
  const int* cache_pos;  // one int32 on the device, as the TPU's cpos_ref
  float scale, cap;
  int window, linear;
};

// What the split plan and the choice of instantiation read: shapes, the
// K/V base pointers and strides (for 16-byte alignment). It holds no
// cache_pos, valid_from or positions, so no plan can depend on them.
struct DecodeShape {
  const void* k;
  const void* v;
  int B, S, Hq, KV, hd;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
};

DecodeShape shape_of(const DecodeArgs& a) {
  return DecodeShape{a.k,   a.v,   a.B,   a.S,   a.Hq,  a.KV, a.hd,
                     a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh};
}

// How the lanes of a warp cover rows of HDP elements of type T, and the
// warp tile: each lane holds 4 16-byte pieces of K and 4 of V a tile.
template <typename T, int HDP>
struct Lanes {
  static constexpr int VECN = 16 / sizeof(T);      // elements a 16-byte load
  static constexpr int CPR = HDP / VECN;           // 16-byte pieces a row
  static constexpr int LPR = CPR < 32 ? CPR : 32;  // lanes on one row
  static constexpr int NV = CPR / LPR;             // pieces a lane holds of it
  static constexpr int RW = 32 / LPR;              // rows one warp load covers
  static constexpr int NR = 4 / NV;                // rows a lane holds a tile
  static constexpr int TW = RW * NR;               // slots of a warp tile
  // Bytes of one warp's ring: K and V pieces lane-major, then positions.
  static constexpr int RING16 = STAGES * NR * NV * 32;  // uint4 of K (of V)
  static constexpr int RING_BYTES = (2 * RING16 * 16 + STAGES * TW * 4 + 15)
                                    / 16 * 16;
};

// Shared memory: the warps' rings, then floats: q (then the block's acc)
// [rep][HDP], the warps' acc [WARPS][RW][rep][HDP], their max and sum
// [WARPS][rep] each, the block's max and sum [rep] each.
template <typename T, int HDP>
size_t smem_bytes(int rep) {
  using L = Lanes<T, HDP>;
  return WARPS * L::RING_BYTES +
         sizeof(float) *
             (static_cast<size_t>(rep) * HDP * (1 + WARPS * L::RW) +
              2 * WARPS * rep + 2 * rep);
}

// Element e of a 16-byte piece (e is a constant after unrolling).
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& v, int e) {
  return __uint_as_float(word(v, e));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int e) {
  const uint32_t w = word(v, e >> 1);
  return __uint_as_float(e & 1 ? (w & 0xffff0000u) : (w << 16));
}

// The first n elements of the 16 bytes at p by element loads, the rest
// zero (rows that are not 16-byte aligned).
template <typename T>
__device__ __forceinline__ uint4 load_elems(const T* p, int n) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) w[e] = __float_as_uint(__ldg(f + e));
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n)
        w[e >> 1] |= static_cast<uint32_t>(__ldg(h + e)) << (16 * (e & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 4 bytes from global to shared memory, asynchronously; zero-filled
// when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The shared::cluster address of p (this block's shared memory) in the
// block of the cluster with the given rank, and a float load from it.
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// 4 blocks a SM (at most 128 registers); the element-load variant, which
// spills there, 3.
template <typename T, int HDP, bool VEC>
__global__ void __launch_bounds__(THREADS, VEC ? 4 : 3)
decode_attention_kernel(DecodeArgs a) {
  using L = Lanes<T, HDP>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = a.Hq / a.KV;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  unsigned char* ring = smem + warp * L::RING_BYTES;
  uint4* ring_k = reinterpret_cast<uint4*>(ring);  // [STAGES][NR][NV][32]
  uint4* ring_v = ring_k + L::RING16;
  int* ring_p = reinterpret_cast<int*>(ring_v + L::RING16);  // [STAGES][TW]
  float* qs = reinterpret_cast<float*>(smem + WARPS * L::RING_BYTES);
  float* accs = qs + rep * HDP;                  // [WARPS][RW][rep][HDP]
  float* ms = accs + WARPS * L::RW * rep * HDP;  // [WARPS][rep]
  float* ls = ms + WARPS * rep;                  // [WARPS][rep]
  float* mb = ls + WARPS * rep;                  // [rep]
  float* lb = mb + rep;                          // [rep]

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x;
  const int b = blockIdx.y / a.KV, g = blockIdx.y % a.KV;
  const int gi = lane / L::LPR, li = lane % L::LPR;
  const int cpos = *a.cache_pos, vf = a.vf[b];
  // This block's chunks: blockIdx.x, + splits, + 2 splits, ... of BT
  // slots each; with linear = 1 only those that reach into [vf, cpos]
  // (chunks jlo .. jhi) are read.
  constexpr int BT = WARPS * L::TW;
  int jlo = 0, jhi = (a.S + BT - 1) / BT - 1;
  if (a.linear) {
    jlo = max(vf, 0) / BT;
    jhi = min(jhi, cpos >= 0 ? cpos / BT : -1);
  }
  const int jfirst = jlo + ((static_cast<int>(blockIdx.x) - jlo) % splits +
                            splits) % splits;
  const bool run = jfirst <= jhi;

  if (run) {
    // This warp's tiles: warp tile `warp` of each of the block's chunks,
    // i = 0, 1, ... starting at w0 + i * STEP; with linear = 1 only
    // [ilo, ihi), those that reach into [vf, cpos] (tiles wholly below vf
    // or past cpos are never read).
    const int STEP = splits * BT;
    const int w0 = blockIdx.x * BT + warp * L::TW;
    int ilo = 0, ihi = a.S > w0 ? (a.S - w0 + STEP - 1) / STEP : 0;
    if (a.linear) {
      const int below = vf - (L::TW - 1) - w0;
      ilo = below > 0 ? (below + STEP - 1) / STEP : 0;
      ihi = min(ihi, cpos >= w0 ? (cpos - w0) / STEP + 1 : 0);
    }
    const T* kp = static_cast<const T*>(a.k) + b * a.ksb + g * a.ksh;
    const T* vp = static_cast<const T*>(a.v) + b * a.vsb + g * a.vsh;
    // Tile i into ring stage st: each lane copies its own pieces (and
    // reads only those back); the first lane of a row copies its position.
    auto fetch = [&](int i, int st) {
      const int t0 = w0 + i * STEP, t1 = min(t0 + L::TW, a.S);
      const long long row = t0 + gi;
      const T* kt = kp + row * a.kss + li * L::VECN;
      const T* vt = vp + row * a.vss + li * L::VECN;
      uint4* rk = ring_k + st * L::NR * L::NV * 32 + lane;
      uint4* rv = ring_v + st * L::NR * L::NV * 32 + lane;
#pragma unroll
      for (int n = 0; n < L::NR; ++n) {
        const int slot = t0 + n * L::RW + gi;
        const bool in = slot < t1;
#pragma unroll
        for (int c = 0; c < L::NV; ++c) {
          const int d0 = (c * L::LPR + li) * L::VECN;
          const int cnt = in ? max(0, min(L::VECN, a.hd - d0)) : 0;
          // Within a tile the offsets fit 32 bits; nothing is read where
          // cnt is 0 (the block's first row stands in as the address).
          const int col = c * L::LPR * L::VECN;
          const T* ks = cnt ? kt + n * L::RW * static_cast<int>(a.kss) + col
                            : kp;
          const T* vs = cnt ? vt + n * L::RW * static_cast<int>(a.vss) + col
                            : vp;
          if constexpr (VEC) {
            cp_async16(rk + (n * L::NV + c) * 32, ks, cnt ? 16 : 0);
            cp_async16(rv + (n * L::NV + c) * 32, vs, cnt ? 16 : 0);
          } else {
            rk[(n * L::NV + c) * 32] = load_elems(ks, cnt);
            rv[(n * L::NV + c) * 32] = load_elems(vs, cnt);
          }
        }
        if (li == 0)
          cp_async4(ring_p + st * L::TW + n * L::RW + gi,
                    a.pos + (in ? slot : 0), in ? 4 : 0);
      }
    };
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      if (ilo + st < ihi) fetch(ilo + st, st);
      cp_async_commit();
    }

    const T* qp = static_cast<const T*>(a.q) + b * a.qsb +
                  static_cast<long long>(g) * rep * a.qsh;
    for (int i = tid; i < rep * HDP; i += THREADS) {
      const int r = i / HDP, d = i % HDP;
      qs[i] = d < a.hd ? to_f32(qp[r * a.qsh + d]) * a.scale : 0.0f;
    }
    for (int i = tid; i < WARPS * L::RW * rep * HDP; i += THREADS)
      accs[i] = 0.0f;
    __syncthreads();

    float m_run = REPRO_NEG_INF, l_run = 0.0f;  // lane r: head r's
    for (int i = ilo; i < ihi; ++i) {
      const int st = (i - ilo) % STAGES;
      const int t0 = w0 + i * STEP, t1 = min(t0 + L::TW, a.S);
      cp_async_wait<STAGES - 1>();  // tile i has landed
      __syncwarp();                 // and its positions are seen by all
      uint4 kr[L::NR][L::NV], vr[L::NR][L::NV];
      unsigned ok = 0;
#pragma unroll
      for (int n = 0; n < L::NR; ++n) {
#pragma unroll
        for (int c = 0; c < L::NV; ++c) {
          kr[n][c] = ring_k[(st * L::NR * L::NV + n * L::NV + c) * 32 + lane];
          vr[n][c] = ring_v[(st * L::NR * L::NV + n * L::NV + c) * 32 + lane];
        }
        const int p = ring_p[st * L::TW + n * L::RW + gi];
        bool valid = t0 + n * L::RW + gi < t1 && p >= 0 && p >= vf &&
                     p <= cpos;
        if (a.window) valid = valid && p > cpos - a.window;
        ok |= static_cast<unsigned>(valid) << n;
      }
      __syncwarp();  // every lane has read stage st before it is refilled
      if (i + STAGES < ihi) fetch(i + STAGES, st);
      cp_async_commit();

      for (int r = 0; r < rep; ++r) {
        float qv[L::NV][L::VECN];
#pragma unroll
        for (int c = 0; c < L::NV; ++c)
#pragma unroll
          for (int e = 0; e < L::VECN; e += 4) {
            const float4 t = *reinterpret_cast<const float4*>(
                qs + r * HDP + (c * L::LPR + li) * L::VECN + e);
            qv[c][e] = t.x; qv[c][e + 1] = t.y;
            qv[c][e + 2] = t.z; qv[c][e + 3] = t.w;
          }
        float s[L::NR];
#pragma unroll
        for (int n = 0; n < L::NR; ++n) {
          float dot = 0.0f;
#pragma unroll
          for (int c = 0; c < L::NV; ++c)
#pragma unroll
            for (int e = 0; e < L::VECN; ++e)
              dot = fmaf(qv[c][e], elem<T>(kr[n][c], e), dot);
          s[n] = dot;
        }
        // Sum each row's dot over its LPR lanes (every lane gets it).
#pragma unroll
        for (int o = L::LPR / 2; o > 0; o /= 2)
#pragma unroll
          for (int n = 0; n < L::NR; ++n)
            s[n] += __shfl_xor_sync(FULL, s[n], o);
        float mx = REPRO_NEG_INF;
#pragma unroll
        for (int n = 0; n < L::NR; ++n) {
          s[n] = (ok >> n) & 1u ? softcap_f32(s[n], a.cap) : REPRO_NEG_INF;
          mx = fmaxf(mx, s[n]);
        }
#pragma unroll
        for (int o = L::LPR; o < 32; o *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float m_old = __shfl_sync(FULL, m_run, r);
        const float l_old = __shfl_sync(FULL, l_run, r);
        const float m_new = fmaxf(m_old, mx);
        const float corr = expf(m_old - m_new);
        float psum = 0.0f;
#pragma unroll
        for (int n = 0; n < L::NR; ++n) {
          s[n] = (ok >> n) & 1u ? expf(s[n] - m_new) : 0.0f;
          psum += s[n];
        }
#pragma unroll
        for (int o = L::LPR; o < 32; o *= 2)
          psum += __shfl_xor_sync(FULL, psum, o);
        if (lane == r) {
          m_run = m_new;
          l_run = l_old * corr + psum;
        }
        float* ap = accs + ((warp * L::RW + gi) * rep + r) * HDP;
#pragma unroll
        for (int c = 0; c < L::NV; ++c)
#pragma unroll
          for (int e = 0; e < L::VECN; e += 4) {
            float4* a4 = reinterpret_cast<float4*>(
                ap + (c * L::LPR + li) * L::VECN + e);
            const float4 t = *a4;
            float av[4] = {t.x * corr, t.y * corr, t.z * corr, t.w * corr};
#pragma unroll
            for (int n = 0; n < L::NR; ++n)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                av[j] = fmaf(s[n], elem<T>(vr[n][c], e + j), av[j]);
            *a4 = make_float4(av[0], av[1], av[2], av[3]);
          }
      }
    }
    if (lane < rep) {
      ms[warp * rep + lane] = m_run;
      ls[warp * rep + lane] = l_run;
    }
    __syncthreads();

    // The block's partial: the warps folded in warp order, those that saw
    // nothing valid left out.
    for (int r = tid; r < rep; r += THREADS) {
      float m = REPRO_NEG_INF;
      for (int w = 0; w < WARPS; ++w) {
        const float mw = ms[w * rep + r];
        if (mw > REPRO_NEG_INF * 0.5f) m = fmaxf(m, mw);
      }
      float l = 0.0f;
      for (int w = 0; w < WARPS; ++w) {
        const float mw = ms[w * rep + r];
        if (mw > REPRO_NEG_INF * 0.5f)
          l = fmaf(ls[w * rep + r], expf(mw - m), l);
      }
      mb[r] = m;
      lb[r] = l;
    }
    __syncthreads();
    for (int i = tid; i < rep * HDP; i += THREADS) {
      const int r = i / HDP, d = i % HDP;
      float acc = 0.0f;
      for (int w = 0; w < WARPS; ++w) {
        const float mw = ms[w * rep + r];
        if (!(mw > REPRO_NEG_INF * 0.5f)) continue;
        float sw = 0.0f;
        for (int h = 0; h < L::RW; ++h)
          sw += accs[((w * L::RW + h) * rep + r) * HDP + d];
        acc = fmaf(sw, expf(mw - mb[r]), acc);
      }
      qs[i] = acc;
    }
  } else {
    for (int r = tid; r < rep; r += THREADS) {
      mb[r] = REPRO_NEG_INF;
      lb[r] = 0.0f;
    }
  }
  cluster.sync();  // every block's partial is in its shared memory

  // Each block of the cluster writes a slice of the rep * hd outputs,
  // reading the blocks' partials in rank order.
  T* op = static_cast<T*>(a.o) +
          (static_cast<long long>(b) * a.Hq + g * rep) * a.hd;  // contiguous
  // The partial of block j: rank j's mb, lb and qs, at this block's
  // offsets (every block lays out its shared memory alike).
  unsigned base[MAX_SPLITS];
#pragma unroll
  for (int j = 0; j < MAX_SPLITS; ++j)
    base[j] = j < splits ? map_rank(mb, j) : 0u;
  const unsigned lb_off = 4u * static_cast<unsigned>(lb - mb);
  const int qs_off = 4 * static_cast<int>(qs - mb);  // negative
  for (int o = static_cast<int>(cluster.block_rank()) * THREADS + tid;
       o < rep * a.hd; o += splits * THREADS) {
    const int r = o / a.hd, d = o % a.hd;
    // All reads go out at once; a block that saw nothing valid is left
    // out of the sums.
    float mj[MAX_SPLITS], lj[MAX_SPLITS], aj[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      mj[j] = REPRO_NEG_INF;
      lj[j] = aj[j] = 0.0f;
      if (j < splits) {
        mj[j] = ld_cluster(base[j] + 4u * r);
        lj[j] = ld_cluster(base[j] + lb_off + 4u * r);
        aj[j] = ld_cluster(base[j] + qs_off + 4 * (r * HDP + d));
      }
    }
    float m = REPRO_NEG_INF;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      if (mj[j] > REPRO_NEG_INF * 0.5f) m = fmaxf(m, mj[j]);
    float l = 0.0f, acc = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      if (!(mj[j] > REPRO_NEG_INF * 0.5f)) continue;
      const float f = expf(mj[j] - m);
      l = fmaf(lj[j], f, l);
      acc = fmaf(aj[j], f, acc);
    }
    const bool seen = m > REPRO_NEG_INF * 0.5f;
    op[o] = from_f32<T>(seen ? acc / fmaxf(l, 1e-30f) : 0.0f);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// The launch of one kernel: a cluster is the blocks of one group.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int splits, int groups, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(splits, groups);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Once per device and kernel: the shared-memory opt-in for the largest
// rep, and clusters of up to 16 blocks (left at 8 where the device
// refuses them).
template <typename T, int HDP, bool VEC>
cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(decode_attention_kernel<T, HDP, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<T, HDP>(MAX_REP)));
  if (err != cudaSuccess) return err;
  if (cudaFuncSetAttribute(decode_attention_kernel<T, HDP, VEC>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    cudaGetLastError();  // clear it; the occupancy query then refuses > 8
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

// Clusters of `splits` blocks at this rep that the current device runs
// at once (0 if it cannot run one), asked once per device.
template <typename T, int HDP, bool VEC>
int resident_clusters(int splits, int rep) {
  static int cache[8][MAX_REP + 1][MAX_SPLITS + 1] = {};  // value + 1
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 8 && cache[dev][rep][splits] > 0)
    return cache[dev][rep][splits] - 1;
  ClusterLaunch l(splits, 1, smem_bytes<T, HDP>(rep), nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(
          &n, decode_attention_kernel<T, HDP, VEC>, &l.cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  if (dev < 8) cache[dev][rep][splits] = n + 1;
  return n;
}

struct DecodePlan {
  int splits, chunk, tile, vec, resident;
  size_t smem;
};

// The split plan: chunks of one block tile (4 warp tiles) of S; as many
// blocks a group as S has chunks, at most MAX_SPLITS, fewer while the
// device cannot hold every group's cluster at once. Block c of a cluster
// takes chunks c, c + splits, c + 2 splits, ...
template <typename T, int HDP, bool VEC>
DecodePlan make_plan(const DecodeShape& a) {
  using L = Lanes<T, HDP>;
  const int rep = a.Hq / a.KV, groups = a.B * a.KV;
  const int S = a.S > 0 ? a.S : 1;
  const int block_tile = WARPS * L::TW;
  int splits = max(1, min(MAX_SPLITS, (S + block_tile - 1) / block_tile));
  while (splits > 1 && resident_clusters<T, HDP, VEC>(splits, rep) < groups)
    --splits;
  DecodePlan p;
  p.splits = splits;
  p.chunk = block_tile;
  p.tile = L::TW;
  p.vec = VEC;
  p.smem = smem_bytes<T, HDP>(rep);
  p.resident = resident_clusters<T, HDP, VEC>(p.splits, rep);
  return p;
}

template <typename T, int HDP, bool VEC>
cudaError_t launch(DecodeArgs a, cudaStream_t stream) {
  const cudaError_t err = prepare<T, HDP, VEC>();
  if (err != cudaSuccess) return err;
  const DecodePlan p = make_plan<T, HDP, VEC>(shape_of(a));
  ClusterLaunch l(p.splits, a.B * a.KV, p.smem, stream);
  return cudaLaunchKernelEx(&l.cfg, decode_attention_kernel<T, HDP, VEC>, a);
}

template <typename T, int HDP, bool VEC>
struct Kernel {
  using Type = T;
  static constexpr int hdp = HDP;
  static constexpr bool vec = VEC;
};

// Every row of K and V 16-byte aligned: base pointers, strides, head_dim.
template <typename T>
bool rows_aligned(const DecodeShape& a) {
  const long long n = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.v) % 16 == 0 && a.hd % n == 0 &&
         a.ksb % n == 0 && a.kss % n == 0 && a.ksh % n == 0 &&
         a.vsb % n == 0 && a.vss % n == 0 && a.vsh % n == 0;
}

// Calls fn(Kernel<T, HDP, VEC>{}) for the instantiation these arguments
// take: head_dim padded to 64, 128 or 256; 16-byte loads where rows are
// aligned, element loads otherwise.
template <typename T, typename Fn>
cudaError_t dispatch_hd(const DecodeShape& a, Fn&& fn) {
  const bool vec = rows_aligned<T>(a);
  if (a.hd <= 64)
    return vec ? fn(Kernel<T, 64, true>{}) : fn(Kernel<T, 64, false>{});
  if (a.hd <= 128)
    return vec ? fn(Kernel<T, 128, true>{}) : fn(Kernel<T, 128, false>{});
  return vec ? fn(Kernel<T, 256, true>{}) : fn(Kernel<T, 256, false>{});
}

template <typename Fn>
cudaError_t dispatch(const DecodeShape& a, int dtype, Fn&& fn) {
  // Row offsets within a warp tile are 32-bit.
  if (a.hd < 1 || a.hd > MAX_HEAD_DIM || a.KV < 1 || a.B < 1 ||
      a.Hq % a.KV != 0 || a.Hq / a.KV > MAX_REP || a.kss >= (1 << 25) ||
      a.vss >= (1 << 25))
    return cudaErrorInvalidValue;
  if (dtype == kFloat32) return dispatch_hd<float>(a, fn);
  if (dtype == kBFloat16) return dispatch_hd<__nv_bfloat16>(a, fn);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* pos,
    const int* vf, void* o, int B, int S, int Hq, int KV, int hd,
    long long qsb, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    const int* cache_pos, float scale, float cap, int window, int linear,
    int dtype, void* stream) {
  const DecodeArgs a{q,   k,   v,   pos, vf,  o,   B,   S,         Hq,
                     KV,  hd,  qsb, qsh, ksb, kss, ksh, vsb,       vss,
                     vsh, cache_pos, scale, cap, window, linear};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(shape_of(a), dtype, [&](auto kern) {
    using K = decltype(kern);
    return launch<typename K::Type, K::hdp, K::vec>(a, st);
  });
}

// The plan that decode_attention_fwd launches for these shapes, K/V
// pointers and strides on the current device, which this also prepares:
// out = {blocks a group (one cluster), slots a chunk, slots a warp tile,
// 1 for 16-byte loads else 0, clusters the device holds at once, dynamic
// shared memory bytes a block}.
extern "C" int decode_attention_plan(const void* k, const void* v, int B,
                                     int S, int Hq, int KV, int hd,
                                     long long ksb, long long kss,
                                     long long ksh, long long vsb,
                                     long long vss, long long vsh,
                                     int dtype, int* out) {
  const DecodeShape a{k, v, B, S, Hq, KV, hd, ksb, kss, ksh, vsb, vss, vsh};
  return dispatch(a, dtype, [&](auto kern) {
    using K = decltype(kern);
    const cudaError_t err = prepare<typename K::Type, K::hdp, K::vec>();
    if (err != cudaSuccess) return err;
    const DecodePlan p = make_plan<typename K::Type, K::hdp, K::vec>(a);
    out[0] = p.splits;
    out[1] = p.chunk;
    out[2] = p.tile;
    out[3] = p.vec;
    out[4] = p.resident;
    out[5] = static_cast<int>(p.smem);
    return cudaSuccess;
  });
}
