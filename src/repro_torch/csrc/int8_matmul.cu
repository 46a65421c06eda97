// Weight-only int8 matmul C = X @ (Wq * scale) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py: int8_matmul
// (_kernel). Same function: int8 weights are converted on chip, the
// product accumulates in fp32 over K, and the per-output-channel fp32
// scale is applied once, when the output tile is written. Activations
// stay float (fp32 or bf16 in, the same type out).
//
// What bounds it on this card: at decode (M = batch = 4) each weight byte
// feeds 2 * M FLOPs, so the call would be bound by the weight bytes; it
// runs on the CUDA cores and falls short of the HBM bound on a fixed
// cost per call and on the SM's instruction work (about nine
// instructions per weight byte), not on memory traffic (PERF.md). At
// prefill (M = B * T = 256 ... 2048) each weight is reused M times and
// the call is bound by operations: it runs on the tensor cores, in bf16
// with fp32 sums, two passes for fp32 x (one for bf16 x), so its bound
// is 2 * 2MKN / 989 TFLOP/s (0.0955 ms at M = 2048, K = 2048, N = 5632)
// where the CUDA cores' fp32 rate would give 0.705 ms.
//
// Why bf16 tensor cores compute this function: every int8 weight is
// exact in bf16 (8-bit significand) and a bf16 x bf16 product is exact
// in fp32. An fp32 activation is split into hi = bf16(x) and
// lo = bf16(x - hi), which leaves a residual under about 2^-16 |x|; both
// parts go through the same weight fragments into the same fp32
// accumulators. Emulated on the CPU against the JAX reference
// (tests/test_torch_kernels.py), one part alone misses the 1e-4 of
// max|C| that the fp32 checks hold this kernel to, and two parts meet
// it. The tensor cores round each mma's fp32 sum toward zero; one chain
// of mma over K shrank the sums by an error that grew with K (1.3e-5 of
// max|C| at K = 5632, 1.79e-5 at 7680, 5.3e-5 at 22016 on the card,
// PERF.md), so each 16 rows of K sum into fresh accumulators, folded into
// the running sums by IEEE adds (pf_mma below).
//
// Design: two paths behind one entry point.
// - M > SMALL_M (prefill): block tiles of BM x BN outputs (128 x 128 with
//   8 warps of 64 x 32, or 64 x 64 with 4 warps of 32 x 32), K in stages
//   of 32 (the TPU's sequential K grid axis becomes this loop). A ring
//   of 2 (large tile) or 3 (small tile) stages in dynamic shared memory
//   is filled by 16-byte cp.async copies of x (as loaded, fp32 or bf16)
//   and of the int8 weights, with zero-fill past M, N and K; the next
//   stages load while the current one is converted and multiplied. Each
//   landed stage is converted once per element into bf16 tiles (x into
//   hi and lo parts, int8 into bf16 through the byte permute of
//   unpack16, exactly), whose rows are padded by 16 bytes so that
//   ldmatrix is free of bank conflicts. Warps read their fragments with
//   ldmatrix (ldmatrix.trans for the k-major weights) and issue
//   mma.sync m16n8k16 bf16 with fp32 accumulators. The epilogue scales
//   and writes the tile. The launcher takes the 128 x 128 tile when its
//   grid gives a block to at least three quarters of the SMs, the
//   64 x 64 tile otherwise; x or w that is not 16-byte aligned row by
//   row (lda, N % 16, a base pointer) takes a 64 x 64 variant whose
//   stages are filled by element and byte loads. No split-K, no
//   atomics: two calls give the same bits.
// - M <= SMALL_M (decode): a split-K weight stream, one launch per call.
//   The grid is (column tiles of 128) x (K slices), and the K slices of
//   one column tile form a thread-block cluster (at most 8 blocks). The
//   launcher picks the slice count from N, K and the device: about two
//   blocks on every SM, but no more slices than lets every tile's cluster
//   run at once (cudaOccupancyMaxActiveClusters), so the grid is one
//   wave. Each thread loads 16 consecutive int8 columns of one weight row
//   with one 16-byte load (8 threads per 128-byte row, 32 rows in flight
//   per block, the next rows loaded while the current ones are summed)
//   and converts them in registers. The block's slice of x is staged once
//   in shared memory as fp32 and read as broadcasts; M is rounded up to 4
//   or 8 at compile time so the accumulators stay in registers. A block
//   sums its rows in a fixed order (warp shuffles, then warps in turn)
//   and pushes each chunk of the sums into the shared memory of the slice
//   block that owns the chunk (DSMEM); after one cluster barrier each
//   block adds the slices of its chunks in slice order, scales and writes
//   them. No workspace, no atomics, no second launch: the result does not
//   depend on block scheduling, and two calls give the same bits. A
//   weight pointer that is not 16-byte aligned, or N % 16 != 0, takes
//   byte loads.
// Both read x through its row stride and mask the ragged edges of M, N
// and K here, so the wrapper does not pad.
// Later work: the prefill path on wgmma fed by TMA with a producer warp
// (mma.sync runs below wgmma's peak, and the conversion pass and two
// block barriers a stage leave the tensor cores idle in between); for
// the decode path, a smaller fixed cost per call and fewer instructions
// per weight byte.

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int SMALL_M = 8;

// Small-M geometry.
constexpr int SM_THREADS = 256;
constexpr int SM_WARPS = SM_THREADS / 32;
constexpr int SM_VEC = 16;                        // int8 columns a thread loads
constexpr int SM_TILE_N = 128;                    // columns of a block
constexpr int SM_TPR = SM_TILE_N / SM_VEC;        // threads on one weight row
constexpr int SM_ROWS = SM_THREADS / SM_TPR;      // weight rows in flight
constexpr int SM_MAX_SPLITS = 8;                  // K slices: a portable cluster
constexpr int SM_BLOCKS_PER_SM = 2;               // the grid's aim
// Rows of x staged at a time. The x chunk (SM_XROWS x MT) and the warps'
// partial sums (SM_WARPS x MT x SM_TILE_N) share one buffer.
constexpr int SM_XROWS = SM_WARPS * SM_TILE_N;

// 16 int8 columns of one weight row, whose first column c is < N. VEC:
// one 16-byte load (N % 16 == 0 and w 16-byte aligned, so all 16 are
// < N); else byte loads, masked per column and packed into the same
// register layout.
template <bool VEC>
__device__ __forceinline__ int4 load16(const int8_t* p, int c, int N) {
  if (VEC) return __ldg(reinterpret_cast<const int4*>(p));
  unsigned int v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < SM_VEC; ++j)
    if (c + j < N)
      v[j / 4] |= static_cast<unsigned int>(static_cast<uint8_t>(__ldg(p + j)))
                  << (8 * (j % 4));
  return make_int4(v[0], v[1], v[2], v[3]);
}

// Signed bytes to fp32, exactly: bias each byte to [0, 255], place it in
// the low mantissa bits of 2^23 (0x4B0000bb), subtract 2^23 + 128.
__device__ __forceinline__ void unpack16(const int4& v, float* f) {
  const unsigned int words[4] = {static_cast<unsigned int>(v.x),
                                 static_cast<unsigned int>(v.y),
                                 static_cast<unsigned int>(v.z),
                                 static_cast<unsigned int>(v.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned int u = words[i] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] =
          __int_as_float(static_cast<int>(__byte_perm(u, 0x4B000000u,
                                                      0x7540u | b))) -
          8388736.0f;
  }
}

// Rows r, r + SM_ROWS, ... (U of them) of this block's K slice; zeros
// past its end or right of column N.
template <bool VEC, int U>
__device__ __forceinline__ void load_rows(int4* dst, const int8_t* wt, int r,
                                          int klen, bool col_ok, int c,
                                          int N) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int kk = r + u * SM_ROWS;
    dst[u] = col_ok && kk < klen
                 ? load16<VEC>(wt + static_cast<long long>(kk) * N, c, N)
                 : make_int4(0, 0, 0, 0);
  }
}

// Cluster barrier halves (PTX barrier.cluster): arrive, then wait. The
// default arrive releases and the wait acquires, so shared-memory writes
// before the arrive are seen by every block of the cluster after its wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Block (tile, split) sums C[:, tile cols] over K rows
// [split * k_split, (split + 1) * k_split); the gridDim.y slices of a
// tile are one cluster. MT: M rounded up to 4 or 8.
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(SM_THREADS, MT >= 8 ? 1 : SM_BLOCKS_PER_SM)
int8_matmul_small_m(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ out,
                    int M, int N, int K, long long lda, int k_split) {
  constexpr int U = MT >= 8 ? 2 : 4;  // rows a thread has in flight, x2
  constexpr int NV = MT * SM_VEC;
  // The tile's MT * SM_TILE_N outputs, in chunks of one per thread; chunk
  // ch belongs to the block of slice ch % splits, which sums it.
  constexpr int CHUNKS = (MT * SM_TILE_N + SM_THREADS - 1) / SM_THREADS;
  __shared__ __align__(16) float smem[SM_XROWS * MT];
  // Partial sums pushed by the slices: [ch / splits][slice][thread].
  __shared__ float inbox[(CHUNKS + SM_MAX_SPLITS - 1) * SM_THREADS];
  cluster_arrive_relaxed();  // paired with the wait before the pushes

  const int tid = threadIdx.x;
  const int rg = tid / SM_TPR, cl = tid % SM_TPR;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n0 = blockIdx.x * SM_TILE_N;
  const int c = n0 + cl * SM_VEC;
  const int k0 = split * k_split;
  const int klen = max(0, min(k_split, K - k0));
  const bool col_ok = c < N;
  // Scales of the outputs this block writes at the end, loaded early.
  float sc[CHUNKS];
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int o = (split + q * splits) * SM_THREADS + tid;
    const int n = n0 + o % SM_TILE_N;
    sc[q] = o < MT * SM_TILE_N && n < N ? __ldg(scale + n) : 0.0f;
  }

  float acc[NV];  // acc[m * SM_VEC + j]: row m, column c + j
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.0f;

  for (int kc = 0; kc < klen; kc += SM_XROWS) {
    const int clen = min(SM_XROWS, klen - kc);
    const int8_t* wt = w + static_cast<long long>(k0 + kc) * N + c;
    // The first weight rows go out before x is staged.
    int4 cur[U];
    load_rows<VEC, U>(cur, wt, rg, clen, col_ok, c, N);
    if (kc > 0) __syncthreads();  // the previous x chunk is read
    // Stage x as smem[kk * MT + m]; a thread's loads all go out before
    // its stores.
    float xs[MT][SM_XROWS / SM_THREADS];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < SM_XROWS / SM_THREADS; ++q) {
        const int kk = tid + q * SM_THREADS;
        xs[m][q] = m < M && kk < clen ? to_f32(x[m * lda + k0 + kc + kk])
                                      : 0.0f;
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < SM_XROWS / SM_THREADS; ++q) {
        const int kk = tid + q * SM_THREADS;
        if (kk < clen) smem[kk * MT + m] = xs[m][q];
      }
    __syncthreads();
    for (int r = rg; r < clen; r += U * SM_ROWS) {
      int4 nxt[U];
      load_rows<VEC, U>(nxt, wt, r + U * SM_ROWS, clen, col_ok, c, N);
      // x of all U rows first (a row past the chunk reads row 0, unused),
      // so the shared-memory latency is paid once.
      float xv[U][MT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = r + u * SM_ROWS < clen ? r + u * SM_ROWS : 0;
#pragma unroll
        for (int m = 0; m < MT; m += 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(&smem[kk * MT + m]);
          xv[u][m] = t.x; xv[u][m + 1] = t.y;
          xv[u][m + 2] = t.z; xv[u][m + 3] = t.w;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * SM_ROWS >= clen) break;
        float wf[SM_VEC];
        unpack16(cur[u], wf);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < SM_VEC; ++j)
            acc[m * SM_VEC + j] = fmaf(xv[u][m], wf[j], acc[m * SM_VEC + j]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
  }
  __syncthreads();  // x is dead; smem now holds the warps' partial sums

  // The warp's four rows in flight (lanes 8 and 16 apart) are summed by
  // halving: each exchange keeps half of the values, adds the partner's
  // copy of them, and sends it the other half. Every sum is taken in one
  // fixed order. Then lane holds the NV / 4 sums base, ..., base + NV/4 - 1.
  static_assert(SM_TPR == 8, "two exchanges, lanes 16 and 8 apart");
  const int warp = tid / 32, lane = tid % 32;
  const bool hi16 = lane & 16, hi8 = lane & 8;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    const float send = hi16 ? acc[i] : acc[i + NV / 2];
    const float keep = hi16 ? acc[i + NV / 2] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < NV / 4; ++i) {
    const float send = hi8 ? acc[i] : acc[i + NV / 4];
    const float keep = hi8 ? acc[i + NV / 4] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const int base = (hi16 ? NV / 2 : 0) + (hi8 ? NV / 4 : 0);
#pragma unroll
  for (int i = 0; i < NV / 4; ++i) {
    const int m = (base + i) / SM_VEC, j = (base + i) % SM_VEC;
    smem[(warp * MT + m) * SM_TILE_N + cl * SM_VEC + j] = acc[i];
  }
  __syncthreads();

  // Sum the warps in turn and push each chunk to the shared memory of the
  // block that owns it; one cluster barrier; then each block adds the
  // slices of its chunks in slice order, scales and writes them.
  cluster_wait();  // every block of the cluster has started
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int ch = 0; ch < CHUNKS; ++ch) {
    const int o = ch * SM_THREADS + tid;
    if (o >= MT * SM_TILE_N) break;
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < SM_WARPS; ++p) s += smem[p * MT * SM_TILE_N + o];
    cluster.map_shared_rank(inbox, ch % splits)
        [((ch / splits) * splits + split) * SM_THREADS + tid] = s;
  }
  cluster_arrive();
  cluster_wait();
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int o = (split + q * splits) * SM_THREADS + tid;
    const int m = o / SM_TILE_N, n = n0 + o % SM_TILE_N;
    if (o >= MT * SM_TILE_N || m >= M || n >= N) continue;
    float v[SM_MAX_SPLITS];
#pragma unroll
    for (int p = 0; p < SM_MAX_SPLITS; ++p)
      v[p] = p < splits ? inbox[(q * splits + p) * SM_THREADS + tid] : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < SM_MAX_SPLITS; ++p)
      if (p < splits) s += v[p];
    out[static_cast<long long>(m) * N + n] = from_f32<T>(s * sc[q]);
  }
}

// SMs of the current device, asked once per device.
int sm_count() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && cache[dev] > 0) return cache[dev];
  int n = 1;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cache[dev] = n;
  return n;
}

struct SmallMPlan {
  int tiles, splits, k_split;
};

// The launch of one small-M kernel: a cluster is the splits of one tile.
struct SmallMLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  SmallMLaunch(const SmallMPlan& p, cudaStream_t stream) {
    cfg.gridDim = dim3(p.tiles, p.splits);
    cfg.blockDim = dim3(SM_THREADS);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = p.splits;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of `splits` blocks of this kernel that the current device runs
// at once, asked once per device and cluster size.
template <typename T, int MT, bool VEC>
int resident_clusters(int splits) {
  static int cache[64][SM_MAX_SPLITS + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (cache[dev][splits] > 0) return cache[dev][splits];
  SmallMLaunch l(SmallMPlan{1, splits, 1}, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(
          &n, int8_matmul_small_m<T, MT, VEC>, &l.cfg) != cudaSuccess) {
    cudaGetLastError();  // clear it; the plan then keeps its slice count
    return 0;
  }
  cache[dev][splits] = n;
  return n;
}

// The small-M grid: column tiles of SM_TILE_N times `splits` K slices of
// `k_split` rows. It aims at SM_BLOCKS_PER_SM blocks on every SM, with at
// most SM_MAX_SPLITS slices (one portable cluster), each of at least
// SM_ROWS rows (one per row a block has in flight) unless K is shorter;
// then it takes fewer slices while the device cannot run every tile's
// cluster at once (a second wave would double the time). Slice s covers
// rows [s * k_split, min(K, (s + 1) * k_split)); none is empty.
template <typename T, int MT, bool VEC>
SmallMPlan small_m_plan(int N, int K) {
  SmallMPlan p;
  p.tiles = (N + SM_TILE_N - 1) / SM_TILE_N;
  const int want = (SM_BLOCKS_PER_SM * sm_count() + p.tiles - 1) / p.tiles;
  int splits = max(1, min(min(SM_MAX_SPLITS, want), K / SM_ROWS));
  while (splits > 1 && resident_clusters<T, MT, VEC>(splits) > 0 &&
         resident_clusters<T, MT, VEC>(splits) < p.tiles)
    --splits;
  p.k_split = max(1, (K + splits - 1) / splits);
  p.splits = K > 0 ? (K + p.k_split - 1) / p.k_split : 1;
  return p;
}

template <typename T, int MT, bool VEC>
cudaError_t launch_small_m(const T* x, const int8_t* w, const float* scale,
                           T* out, int M, int N, int K, long long lda,
                           cudaStream_t stream) {
  const SmallMPlan p = small_m_plan<T, MT, VEC>(N, K);
  SmallMLaunch l(p, stream);
  return cudaLaunchKernelEx(&l.cfg, int8_matmul_small_m<T, MT, VEC>, x, w,
                            scale, out, M, N, K, lda, p.k_split);
}

template <typename T, int MT>
cudaError_t launch_small_m(const T* x, const int8_t* w, const float* scale,
                           T* out, int M, int N, int K, long long lda,
                           cudaStream_t stream) {
  if (N % SM_VEC == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
    return launch_small_m<T, MT, true>(x, w, scale, out, M, N, K, lda,
                                       stream);
  return launch_small_m<T, MT, false>(x, w, scale, out, M, N, K, lda,
                                      stream);
}

// ---------------------------------------------------------------------------
// M > SMALL_M (prefill): bf16 tensor-core tiles fed by a cp.async ring.

constexpr int PF_BK = 32;      // rows of K in a stage
constexpr int PF_PAD = 8;      // bf16 pad of a converted row: 16 bytes

// A block tile of BM x BN outputs: WARPS_M x WARPS_N warps, each of
// MT x NT mma tiles of 16 x 8. MIN_BLOCKS: blocks an SM should hold
// (caps the registers at 65536 / (THREADS * MIN_BLOCKS)). STAGES: depth
// of the cp.async ring.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int MIN_BLOCKS_,
          int STAGES_>
struct PfTile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_, STAGES = STAGES_;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "whole mma tiles, NT even");
  static_assert(STAGES >= 2, "a stage loads while the last one is used");
};
// Ring depths as timed with the weights cold in L2 (chip_smoke.py
// --phases tune, which builds this file with other -D values): the large
// tile runs where its grid fills the SMs and is quicker with 2 stages;
// the small tile runs at the small M of serving, about one block on each
// SM at N = 2048, where a third stage hides HBM latency.
#ifndef PF_LARGE_STAGES
#define PF_LARGE_STAGES 2
#endif
#ifndef PF_SMALL_STAGES
#define PF_SMALL_STAGES 3
#endif
// 0: the launcher picks the tile (prefill_plan); 128 or 64: aligned
// operands always take that tile (a build for timing the other tile).
#ifndef PF_FORCE_TILE
#define PF_FORCE_TILE 0
#endif
using PfLarge = PfTile<128, 128, 2, 4, 2, PF_LARGE_STAGES>;  // 64 x 32 warps
using PfSmall = PfTile<64, 64, 2, 2, 4, PF_SMALL_STAGES>;    // 32 x 32 warps

// A block's dynamic shared memory, in bytes: the ring of stages as they
// are loaded (x [BM][PF_BK] in T, then w [PF_BK][BN] int8), then the
// converted bf16 tiles (PARTS x [BM][A_LD] of x, [PF_BK][B_LD] of w).
template <typename T, typename TL>
struct PfSmem {
  static constexpr int PARTS = std::is_same<T, float>::value ? 2 : 1;
  static constexpr int X_STAGE = TL::BM * PF_BK * static_cast<int>(sizeof(T));
  static constexpr int W_STAGE = PF_BK * TL::BN;
  static constexpr int A_LD = PF_BK + PF_PAD;
  static constexpr int B_LD = TL::BN + PF_PAD;
  static constexpr int A_PART = TL::BM * A_LD * 2;
  static constexpr int W_RING = TL::STAGES * X_STAGE;
  static constexpr int A_CVT = W_RING + TL::STAGES * W_STAGE;
  static constexpr int B_CVT = A_CVT + PARTS * A_PART;
  static constexpr int BYTES = B_CVT + PF_BK * B_LD * 2;
};

// Fill ring slot `slot` with rows [k0, k0 + PF_BK) of K: x rows from m0,
// w columns from n0; zeros past M, N and K. VEC: 16-byte cp.async
// copies (x rows and w rows 16-byte aligned, N % 16 == 0); else element
// and byte loads, stored as they arrive.
template <typename T, typename TL, bool VEC>
__device__ __forceinline__ void pf_load(unsigned char* smem, int slot,
                                        const T* x, const int8_t* w, int M,
                                        int N, int K, long long lda, int m0,
                                        int n0, int k0) {
  using S = PfSmem<T, TL>;
  T* xs = reinterpret_cast<T*>(smem + slot * S::X_STAGE);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + S::W_RING + slot * S::W_STAGE);
  if constexpr (VEC) {
    constexpr int XV = 16 / static_cast<int>(sizeof(T));  // x per copy
    constexpr int XC = TL::BM * PF_BK / XV;
    constexpr int WC = PF_BK * TL::BN / 16;
    static_assert(XC % TL::THREADS == 0 && WC % TL::THREADS == 0, "");
#pragma unroll
    for (int i = 0; i < XC / TL::THREADS; ++i) {
      const int c = threadIdx.x + i * TL::THREADS;
      const int r = c / (PF_BK / XV), kk = c % (PF_BK / XV) * XV;
      const int gm = m0 + r, gk = k0 + kk;
      const int n = gm < M ? max(0, min(XV, K - gk)) : 0;
      cp_async16(xs + r * PF_BK + kk, n > 0 ? x + gm * lda + gk : x,
                 n * static_cast<int>(sizeof(T)));
    }
#pragma unroll
    for (int i = 0; i < WC / TL::THREADS; ++i) {
      const int c = threadIdx.x + i * TL::THREADS;
      const int r = c / (TL::BN / 16), nn = c % (TL::BN / 16) * 16;
      const int gk = k0 + r, gn = n0 + nn;
      const bool ok = gk < K && gn < N;
      cp_async16(ws + r * TL::BN + nn,
                 ok ? w + static_cast<long long>(gk) * N + gn : w,
                 ok ? 16 : 0);
    }
  } else {
    // x as raw bits (fp32 or bf16), so a zero is a zero of either type.
    using Bits = std::conditional_t<sizeof(T) == 4, unsigned, unsigned short>;
    const Bits* xb = reinterpret_cast<const Bits*>(x);
    Bits* xsb = reinterpret_cast<Bits*>(xs);
    static_assert((TL::BM * PF_BK) % TL::THREADS == 0, "");
#pragma unroll 4
    for (int i = 0; i < TL::BM * PF_BK / TL::THREADS; ++i) {
      const int e = threadIdx.x + i * TL::THREADS;
      const int gm = m0 + e / PF_BK, gk = k0 + e % PF_BK;
      xsb[e] = gm < M && gk < K ? xb[gm * lda + gk] : Bits(0);
    }
#pragma unroll 4
    for (int i = 0; i < PF_BK * TL::BN / TL::THREADS; ++i) {
      const int e = threadIdx.x + i * TL::THREADS;
      const int gk = k0 + e / TL::BN, gn = n0 + e % TL::BN;
      ws[e] = gk < K && gn < N ? w[static_cast<long long>(gk) * N + gn]
                               : int8_t(0);
    }
  }
}

// Convert ring slot `slot` into the bf16 tiles, once per element: fp32 x
// into hi = bf16(x) and lo = bf16(x - hi) (x - hi is exact in fp32),
// bf16 x as it is, int8 w exactly (unpack16's fp32 of |v| <= 128 has a
// zero low half, so its high half is the bf16).
template <typename T, typename TL>
__device__ __forceinline__ void pf_convert(unsigned char* smem, int slot) {
  using S = PfSmem<T, TL>;
  const unsigned char* xs = smem + slot * S::X_STAGE;
  const unsigned char* ws = smem + S::W_RING + slot * S::W_STAGE;
  __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem + S::A_CVT);
  __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(smem + S::B_CVT);
  if constexpr (S::PARTS == 2) {
    __nv_bfloat16* lo = a + S::A_PART / 2;
    constexpr int C = TL::BM * PF_BK / 4;
    static_assert(C % TL::THREADS == 0, "");
#pragma unroll
    for (int i = 0; i < C / TL::THREADS; ++i) {
      const int c = threadIdx.x + i * TL::THREADS;
      const int r = c / (PF_BK / 4), kk = c % (PF_BK / 4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(xs + 16 * c);
      const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
      const __nv_bfloat162 l0 = __floats2bfloat162_rn(
          v.x - __low2float(h0), v.y - __high2float(h0));
      const __nv_bfloat162 l1 = __floats2bfloat162_rn(
          v.z - __low2float(h1), v.w - __high2float(h1));
      *reinterpret_cast<uint2*>(a + r * S::A_LD + kk) =
          make_uint2(bf16x2_bits(h0), bf16x2_bits(h1));
      *reinterpret_cast<uint2*>(lo + r * S::A_LD + kk) =
          make_uint2(bf16x2_bits(l0), bf16x2_bits(l1));
    }
  } else {
    constexpr int C = TL::BM * PF_BK / 8;
    static_assert(C % TL::THREADS == 0, "");
#pragma unroll
    for (int i = 0; i < C / TL::THREADS; ++i) {
      const int c = threadIdx.x + i * TL::THREADS;
      const int r = c / (PF_BK / 8), kk = c % (PF_BK / 8) * 8;
      *reinterpret_cast<uint4*>(a + r * S::A_LD + kk) =
          *reinterpret_cast<const uint4*>(xs + 16 * c);
    }
  }
  constexpr int C = PF_BK * TL::BN / 16;
  static_assert(C % TL::THREADS == 0, "");
#pragma unroll
  for (int i = 0; i < C / TL::THREADS; ++i) {
    const int c = threadIdx.x + i * TL::THREADS;
    const int r = c / (TL::BN / 16), nn = c % (TL::BN / 16) * 16;
    float f[16];
    unpack16(*reinterpret_cast<const int4*>(ws + 16 * c), f);
    unsigned p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      p[j] = __byte_perm(__float_as_uint(f[2 * j]),
                         __float_as_uint(f[2 * j + 1]), 0x7632);
    uint4* dst = reinterpret_cast<uint4*>(b + r * S::B_LD + nn);
    dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// The tensor cores round an mma's fp32 sum toward zero, not to nearest:
// a chain of mma into one accumulator shrinks it by up to an ulp of the
// running sum at each link, an error that grows with K. So each 16 rows
// of K start from zero accumulators (both x parts chained there: the sum
// of 16 rows, whose rounding is small beside the running sums) and are
// added to the running sums by IEEE fp32 adds, which round to nearest.
//
// The warp's products over the converted stage: per 16 rows of K, the
// weight fragments of its NT column tiles (ldmatrix.trans of the k-major
// tile), then per row tile the x parts' fragments and NT mma of both
// parts into fresh accumulators, added to the running sums.
template <typename T, typename TL>
__device__ __forceinline__ void pf_mma(const unsigned char* smem,
                                       float (&acc)[TL::MT][TL::NT][4],
                                       int wm, int wn, int lane) {
  using S = PfSmem<T, TL>;
  const __nv_bfloat16* a =
      reinterpret_cast<const __nv_bfloat16*>(smem + S::A_CVT);
  const __nv_bfloat16* b =
      reinterpret_cast<const __nv_bfloat16*>(smem + S::B_CVT);
  const int q = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < PF_BK; kk += 16) {
    unsigned bf[TL::NT][2];
#pragma unroll
    for (int j = 0; j < TL::NT; j += 2) {
      // Matrices: k 0-7 and 8-15 of column tile j, then of tile j + 1.
      unsigned r[4];
      ldmatrix_x4_trans(r, b + (kk + (q & 1) * 8 + (lane & 7)) * S::B_LD +
                               wn * TL::WN + (j + (q >> 1)) * 8);
      bf[j][0] = r[0];
      bf[j][1] = r[1];
      bf[j + 1][0] = r[2];
      bf[j + 1][1] = r[3];
    }
    // Matrices of a row tile: rows 0-7 and 8-15 at k 0-7, then at k 8-15.
    const auto a_tile = [&](int p, int i) {
      return a + p * (S::A_PART / 2) +
             (wm * TL::WM + i * 16 + (lane & 15)) * S::A_LD + kk +
             (lane >> 4) * 8;
    };
#pragma unroll
    for (int i = 0; i < TL::MT; ++i) {
      unsigned af[S::PARTS][4];
#pragma unroll
      for (int p = 0; p < S::PARTS; ++p) ldmatrix_x4(af[p], a_tile(p, i));
#pragma unroll
      for (int j = 0; j < TL::NT; ++j) {
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int p = 0; p < S::PARTS; ++p)
          mma_bf16(t, af[p], bf[j][0], bf[j][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
      }
    }
  }
}

// Two neighbouring outputs; one paired store when the pair is aligned.
__device__ __forceinline__ void store2(float* o, float v0, float v1,
                                       bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
    o[1] = v1;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float v0, float v1,
                                       bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    o[0] = __float2bfloat16(v0);
    o[1] = __float2bfloat16(v1);
  }
}

// Block (blockIdx.y, blockIdx.x) computes C[m0 : m0 + BM, n0 : n0 + BN].
template <typename T, typename TL, bool VEC>
__global__ void __launch_bounds__(TL::THREADS, TL::MIN_BLOCKS)
int8_matmul_prefill(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ out,
                    int M, int N, int K, long long lda) {
  extern __shared__ __align__(16) unsigned char pf_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * TL::BN;
  const int stages = (K + PF_BK - 1) / PF_BK;

  float acc[TL::MT][TL::NT][4];
#pragma unroll
  for (int i = 0; i < TL::MT; ++i)
#pragma unroll
    for (int j = 0; j < TL::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // Stage s goes to slot s % STAGES as one commit group (an empty group
  // past the last stage), so waiting until STAGES - 2 groups are left in
  // flight waits for stage kt.
#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (s < stages)
      pf_load<T, TL, VEC>(pf_smem, s, x, w, M, N, K, lda, m0, n0, s * PF_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < stages; ++kt) {
    cp_async_wait<TL::STAGES - 2>();
    // Stage kt has landed for every thread, and every warp is done with
    // the products of stage kt - 1: its slot and the bf16 tiles are free.
    __syncthreads();
    const int next = kt + TL::STAGES - 1;
    if (next < stages)
      pf_load<T, TL, VEC>(pf_smem, next % TL::STAGES, x, w, M, N, K, lda, m0,
                          n0, next * PF_BK);
    cp_async_commit();
    pf_convert<T, TL>(pf_smem, kt % TL::STAGES);
    __syncthreads();
    pf_mma<T, TL>(pf_smem, acc, wm, wn, lane);
  }

  // Accumulator e of tile (i, j): row g (+ 8 for e >= 2), column 2t + e % 2.
  const int g = lane >> 2, t = lane & 3;
  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < TL::NT; ++j) {
    const int n = n0 + wn * TL::WN + j * 8 + 2 * t;
    const float s0 = n < N ? __ldg(scale + n) : 0.0f;
    const float s1 = n + 1 < N ? __ldg(scale + n + 1) : 0.0f;
#pragma unroll
    for (int i = 0; i < TL::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * TL::WM + i * 16 + g + 8 * h;
        if (m >= M || n >= N) continue;
        T* o = out + static_cast<long long>(m) * N + n;
        const float v0 = acc[i][j][2 * h] * s0;
        const float v1 = acc[i][j][2 * h + 1] * s1;
        if (n + 1 < N)
          store2(o, v0, v1, pair);
        else
          o[0] = from_f32<T>(v0);
      }
  }
}

struct PfPlan {
  int bm, bn;
  bool vec;
};

// The prefill variant for these operands: 16-byte copies when x rows and
// w rows are 16-byte aligned; the 128 x 128 tile when its grid gives a
// block to at least three quarters of the SMs, else the 64 x 64 tile
// (chip_smoke.py --phases tune times both at each projection). A build
// with PF_FORCE_TILE set takes that tile for all aligned operands.
template <typename T>
PfPlan prefill_plan(const T* x, const int8_t* w, int M, int N,
                    long long lda) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   lda * static_cast<long long>(sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % 16 == 0;
  const long long large =
      static_cast<long long>((M + PfLarge::BM - 1) / PfLarge::BM) *
      ((N + PfLarge::BN - 1) / PfLarge::BN);
  const bool take_large = PF_FORCE_TILE == 0
                              ? 4 * large >= 3 * sm_count()
                              : PF_FORCE_TILE == PfLarge::BM;
  if (vec && take_large)
    return {PfLarge::BM, PfLarge::BN, true};
  return {PfSmall::BM, PfSmall::BN, vec};
}

template <typename T, typename TL, bool VEC>
cudaError_t launch_prefill(const T* x, const int8_t* w, const float* scale,
                           T* out, int M, int N, int K, long long lda,
                           cudaStream_t stream) {
  constexpr int smem = PfSmem<T, TL>::BYTES;
  static bool opted_in[64] = {};
  const cudaError_t err =
      smem_opt_in(int8_matmul_prefill<T, TL, VEC>, smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM);
  int8_matmul_prefill<T, TL, VEC><<<grid, TL::THREADS, smem, stream>>>(
      x, w, scale, out, M, N, K, lda);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* w, const float* scale,
                   void* out, int M, int N, int K, long long lda,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (M <= SMALL_M) {
    // M rounds up to 4 or 8 rows of accumulators; rows past M are zero.
    if (M <= 4)
      return launch_small_m<T, 4>(xp, w, scale, op, M, N, K, lda, stream);
    return launch_small_m<T, 8>(xp, w, scale, op, M, N, K, lda, stream);
  }
  const PfPlan p = prefill_plan(xp, w, M, N, lda);
  if (!p.vec)
    return launch_prefill<T, PfSmall, false>(xp, w, scale, op, M, N, K, lda,
                                             stream);
  if (p.bm == PfLarge::BM)
    return launch_prefill<T, PfLarge, true>(xp, w, scale, op, M, N, K, lda,
                                            stream);
  return launch_prefill<T, PfSmall, true>(xp, w, scale, op, M, N, K, lda,
                                          stream);
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

// The small-M grid for N and K on the current device, and how many of its
// clusters the device runs at once (fp32 x, M <= 4, 16-byte loads):
// out = {column tiles, K slices, rows per slice, resident clusters}.
extern "C" int int8_matmul_small_m_plan(int N, int K, int* out) {
  const SmallMPlan p = small_m_plan<float, 4, true>(N, K);
  out[0] = p.tiles;
  out[1] = p.splits;
  out[2] = p.k_split;
  out[3] = resident_clusters<float, 4, true>(p.splits);
  return cudaSuccess;
}

// Rows of x up to which a call takes the small-M (decode) path.
extern "C" int int8_matmul_small_m_rows() { return SMALL_M; }

// The prefill variant a call with these operands takes (M > SMALL_M):
// out = {block rows, block columns, 1 for 16-byte copies else 0}.
extern "C" int int8_matmul_prefill_plan(const void* x, const void* w, int M,
                                        int N, long long lda, int dtype,
                                        int* out) {
  const int8_t* wq = static_cast<const int8_t*>(w);
  PfPlan p;
  if (dtype == kFloat32)
    p = prefill_plan(static_cast<const float*>(x), wq, M, N, lda);
  else if (dtype == kBFloat16)
    p = prefill_plan(static_cast<const __nv_bfloat16*>(x), wq, M, N, lda);
  else
    return cudaErrorInvalidValue;
  out[0] = p.bm;
  out[1] = p.bn;
  out[2] = p.vec;
  return cudaSuccess;
}
