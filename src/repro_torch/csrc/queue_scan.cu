// The open-loop queue recurrence of the scan engine
// (serving/scan_engine.py: scan_event_phase), as one CUDA kernel.
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// `lax.scan` (src/repro/serving/scan_engine.py:727), mirroring the python
// event loop (serving/simulator.py:453-458). No torch op expresses its
// dependent chain, and a Python loop of N launches would be slower than
// the python engine, so the port runs it as a kernel. In request order,
// with a = arrival + upload, e = execution time, S servers and
// thr = 0.05 * t_sla:
//   s      = the first argmin of the servers' free times
//   start  = max(a_i, free[s])
//   active:   free[s] = start + e_i, queue_i = start - a_i
//   inactive: queue_i = 0 (an on-device fallback never queues)
//   hedges += active & S > 1 & ((p95_i & start - a_i > thr) | outage_i)
// It has no products, so nothing can be contracted into a fused
// multiply-add, and fp64 max, add and subtract are exact IEEE ops: the
// kernel gives the python loop's bits.
//
// Bound: each step depends on the one before (the free times), so the
// chain of one step (the min over S free times, the max, the add) at
// fp64 latency bounds it, far above its bytes (27 a request: a, e, three
// gate bytes in; the queue out). One thread runs the chain, looping over
// the free times: in shared memory for up to kSharedServers servers, else
// in the S-double device buffer the caller passes (any S), read through
// one pointer by the same loop. On an H100 at S = 2 the loop takes about
// 330 cycles a request. Free times held in registers (S <= 8 only) took
// 103, and the loop built once for each home (shared accesses as
// shared-memory instructions) 6% less: neither is worth a second path
// while the queue is milliseconds of a simulate that takes seconds. The
// block's other warps stage the next chunk of inputs into shared memory,
// so the chain never waits on device memory for them.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 1024;          // requests a stage holds
constexpr int kThreads = 128;         // thread 0 runs the chain; warps 1-3 stage
constexpr int kSharedServers = 1536;  // free times kept in shared memory

struct Stage {
  double a[kChunk];
  double e[kChunk];
  unsigned char g[kChunk];  // bit 0: p95 gate, 1: outage gate, 2: active
};

__device__ __forceinline__ void stage_chunk(
    Stage& st, const double* __restrict__ a, const double* __restrict__ e,
    const bool* __restrict__ p95, const bool* __restrict__ outage,
    const bool* __restrict__ active, long long base, long long n, int t,
    int nt) {
  for (int i = t; i < kChunk; i += nt) {
    const long long k = base + i;
    if (k < n) {
      st.a[i] = a[k];
      st.e[i] = e[k];
      st.g[i] = (p95[k] ? 1 : 0) | (outage[k] ? 2 : 0) | (active[k] ? 4 : 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    queue_scan_kernel(const double* __restrict__ a,
                      const double* __restrict__ e,
                      const bool* __restrict__ p95,
                      const bool* __restrict__ outage,
                      const bool* __restrict__ active, long long n,
                      int n_servers, double thr, double* device_free,
                      double* __restrict__ queue,
                      long long* __restrict__ hedges_out) {
  __shared__ Stage stages[2];
  __shared__ double shared_free[kSharedServers];
  double* free_t = n_servers <= kSharedServers ? shared_free : device_free;
  const int t = threadIdx.x;
  for (int k = t; k < n_servers; k += blockDim.x) free_t[k] = 0.0;
  long long hedges = 0;
  const bool hedgeable = n_servers > 1;
  const long long chunks = (n + kChunk - 1) / kChunk;
  stage_chunk(stages[0], a, e, p95, outage, active, 0, n, t, blockDim.x);
  __syncthreads();
  for (long long c = 0; c < chunks; ++c) {
    const Stage& cur = stages[c & 1];
    if (t >= 32) {
      if (c + 1 < chunks)
        stage_chunk(stages[(c + 1) & 1], a, e, p95, outage, active,
                    (c + 1) * kChunk, n, t - 32, blockDim.x - 32);
    } else if (t == 0) {
      const long long base = c * kChunk;
      const int len = (int)min((long long)kChunk, n - base);
      for (int i = 0; i < len; ++i) {
        // The first argmin (strict <: ties keep the lowest index).
        int s = 0;
        double m = free_t[0];
        for (int k = 1; k < n_servers; ++k)
          if (free_t[k] < m) {
            m = free_t[k];
            s = k;
          }
        const double ai = cur.a[i];
        const unsigned g = cur.g[i];
        const double start = m > ai ? m : ai;  // python's max(a, free[s])
        const double wait = start - ai;
        if (g & 4) {
          hedges += hedgeable && (((g & 1) && wait > thr) || (g & 2));
          free_t[s] = start + cur.e[i];
          queue[base + i] = wait;
        } else {
          queue[base + i] = 0.0;  // an on-device fallback never queues
        }
      }
    }
    __syncthreads();
  }
  if (t == 0) *hedges_out = hedges;
}

// A dependent chain of fp64 adds on one thread, timed by the SM's clock.
__global__ void fp64_add_latency_kernel(long long iters, double x, double y,
                                        long long* cycles, double* sink) {
  const long long t0 = clock64();
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 16; ++k) x = x + y;
  }
  const long long t1 = clock64();
  *cycles = t1 - t0;
  *sink = x;
}

}  // namespace

// queue (N,) float64 and hedges (one int64) from a, e (N,) float64 and the
// three (N,) bool gates, on `stream`; n_servers >= 1, and device_free
// (n_servers doubles on the device) holds the free times where they do not
// fit in shared memory.
extern "C" int queue_scan_fwd(const void* a, const void* e, const void* p95,
                              const void* outage, const void* active,
                              long long n, int n_servers, double thr,
                              void* device_free, void* queue, void* hedges,
                              void* stream) {
  if (n_servers < 1) return cudaErrorInvalidValue;
  queue_scan_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(e),
      static_cast<const bool*>(p95), static_cast<const bool*>(outage),
      static_cast<const bool*>(active), n, n_servers, thr,
      static_cast<double*>(device_free), static_cast<double*>(queue),
      static_cast<long long*>(hedges));
  return cudaGetLastError();
}

// Cycles of `iters` x 16 dependent fp64 adds on one thread, written to
// cycles[0] (sink[0] keeps the sum live): the latency that the queue
// recurrence's bound counts for each link of a step's chain.
extern "C" int queue_scan_fp64_add_cycles(long long iters, void* cycles,
                                          void* sink, void* stream) {
  fp64_add_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, 1.0, 1e-9, static_cast<long long*>(cycles),
      static_cast<double*>(sink));
  return cudaGetLastError();
}
