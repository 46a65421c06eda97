// Weight-only int8 matmul C = X @ (Wq * scale) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py: int8_matmul
// (_kernel). Same function: int8 weights are converted on chip, the
// product accumulates in fp32 over K, and the per-output-channel fp32
// scale is applied once, when the output tile is written. Activations
// stay float (fp32 or bf16 in, the same type out).
//
// What bounds it on this card: at decode (M = batch = 4) each weight byte
// feeds 2 * M FLOPs, so the call would be bound by the weight bytes; at
// prefill (M = B * T = 2048) each weight is reused M times and the call
// is bound by operations. The products stay IEEE fp32 (no TF32), so both
// run on the CUDA cores. The decode path falls short of the HBM bound on
// a fixed cost per call and on the SM's instruction work (about nine
// instructions per weight byte), not on memory traffic (PERF.md).
//
// Design: two paths behind one entry point.
// - M > SMALL_M: a shared-memory tiled product, 64 x 64 output tile per
//   block of 256 threads, 4 x 4 outputs per thread, K in steps of 16
//   (the TPU's sequential K grid axis becomes this loop).
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
// Later work: the prefill path on wgmma (bf16 activations, int8 -> bf16
// in registers) fed by TMA; for the decode path, a smaller fixed cost
// per call and fewer instructions per weight byte.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TM = 64, TN = 64, TK = 16, TILE_THREADS = 256;
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
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  int8_matmul_tiled<T><<<grid, TILE_THREADS, 0, stream>>>(
      xp, w, scale, op, M, N, K, lda);
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
