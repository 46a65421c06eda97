// The request-axis scan of the scan cluster engine
// (serving/cluster_engine.py: scan_cluster_run's phase 3), as one CUDA
// kernel.
//
// Replaces no Pallas kernel: the reference runs this scan as a
// `lax.scan` (src/repro/serving/cluster_engine.py:527) whose step mirrors
// the python `Cluster.submit` op for op. For every request in arrival
// order, with R replicas of K models each (E = R * K hot/LRU entries):
//   1. switch scale: n1 = clip(n_act + sign(alarm), min_active, R);
//   2. the queue delay max(0, free[r] - arrive) of each active replica;
//   3. load scale-up (n2 = n1 + 1) when the least delay exceeds
//      headroom * sla;
//   4. the SLA-class-priority shed;
//   5. the placement: the lexmin of (delay, -capacity, index) over the
//      n2 active replicas (j1), and the runner-up (j2), by exact float
//      equality and first-index ties, as the reference's argmin/argmax;
//   6. leg 1 on j1 (masked on a shed row: its selection and times are
//      still computed, no state moves): the model choice (cnnselect's
//      CDF count, a random draw or the precomputed one), the global-LRU
//      eviction loop under the memory budget (first argmin of the last-
//      use times over the other hot entries), cold start and execution
//      from the replica's pre-drawn normals;
//   7. leg 2 on j2, the hedge, only where the request hedges (degraded,
//      hedging on, two or more active replicas); elsewhere its outputs
//      are 0 and its victims -1, as the reference's `_skip`;
//   8. strict first-completion-wins.
//
// Rounding: the python engine rounds every product before a sum; nvcc
// contracts a*b + c into a fused multiply-add at -O3, so the three
// products that feed sums (xmu + xsgp*z, mu + sgp*z, 2*ti + queue + exc)
// are written with __dmul_rn / __dadd_rn. The quotient by the replica's
// speed is an IEEE double division. Every other op is a compare, select,
// max, add or subtract: the kernel gives the reference's bits.
//
// Shape: each request depends on the state its predecessors left (free
// times, hot set, hot bytes, active prefix, draw counters), so one thread
// runs the chain. The state lives in shared memory up to kSharedReplicas
// replicas and kSharedEntries entries, else in the final-carry device
// buffers (any R and K), read through the same pointers. The block's
// other warps stage the next chunk of per-request columns into shared
// memory, fill its victim rows with -1 and prefetch its selection and
// CDF rows, so the chain reads its per-request inputs from shared memory
// or L1. The replicas' pre-drawn streams (u, ri, z) are read at each
// replica's own counter.
//
// Bound: the chain through the free times, ceil(log2 R) + 5 dependent
// fp64 links a request (a delay's subtract and max, the min over the
// active replicas, the compare that picks the replica, the max with the
// arrival, the add of the execution time), far above its bytes (about
// 270 a request at R = K = 3). One thread's instruction and load
// latencies hold the kernel well above that chain: on an H100 80GB HBM3
// at 700 W, 4381 cycles a request at R = 3 (chain: 56), 2447 at R = 1
// and 15655 at R = 32 (chip_smoke.py --phases build,profile_cluster).
#include <cuda_runtime.h>

#include <cstdint>

// The kernel's operands, mirrored by kernels/cluster_scan.py's _Args.
struct ClusterScanArgs {
  // Per request: (N,) columns, sel (N, R), cdf (N, R, K) (null when no
  // replica runs cnnselect).
  const double* arr;
  const double* ti;
  const double* slac;
  const double* slar;
  const bool* has;
  const double* prio;
  const double* od;
  const bool* degr;
  const int8_t* al;
  const int* sel;
  const double* cdf;
  // Constants: (E,) profiles, (R,) replicas, the pre-drawn streams and
  // five 0-d scalars.
  const double* mu;
  const double* sgp;
  const double* p1mu;
  const double* xmu;
  const double* xsgp;
  const long long* sizes;
  const double* cap;
  const double* speed;
  const int* kind;
  const double* u;   // (R, u_cols)
  const int* ri;     // (R, ri_cols)
  const double* z;   // (R, 2N)
  const long long* budget;
  const int* min_active;
  const bool* hedge;
  const double* shed_factor;
  const double* headroom;
  // The initial carry.
  const double* free0;
  const bool* hot0;
  const double* last0;
  const long long* hb0;
  const int* n_act0;
  const int* up0;
  const int* zp0;
  // The final carry (written).
  double* free_out;
  bool* hot_out;
  double* last_out;
  long long* hb_out;
  int* n_act_out;
  int* up_out;
  int* zp_out;
  // The (N,) outputs, and the (N, E) victims (null without a budget).
  int* scale1;
  int* scale2;
  bool* shed;
  bool* hedged;
  int* j1;
  int* sel1;
  bool* place1;
  int* j2;
  int* sel2;
  bool* place2;
  int* jw;
  int* flatw;
  double* qw;
  double* xw;
  double* e2ew;
  bool* okw;
  int* vict1;
  int* vict2;
  long long n;
  long long u_cols;
  long long ri_cols;
  int R;
  int K;
  int has_budget;
};

namespace {

constexpr int kChunk = 256;     // requests a stage holds
constexpr int kThreads = 128;   // thread 0 runs the chain; warps 1-3 stage
// Free times and draw counters of up to kSharedReplicas replicas, hot
// flags and last uses of up to kSharedEntries entries in shared memory.
constexpr int kSharedReplicas = 256;
constexpr int kSharedEntries = 1024;

struct Stage {
  double arr[kChunk];
  double ti[kChunk];
  double slac[kChunk];
  double slar[kChunk];
  double prio[kChunk];
  double od[kChunk];
  signed char al[kChunk];
  unsigned char flags[kChunk];  // bit 0: has an SLA, 1: degraded regime
};

// The mutable cluster state, in shared memory or in the final-carry
// buffers.
struct State {
  double* free;
  bool* hot;
  double* last;
  int* up;
  int* zp;
  long long hb;
};

struct Leg {
  int sel;
  int flat;
  bool need;
  double queue;
  double exc;
  double e2e;
};

__device__ __forceinline__ void stage_chunk(Stage& st,
                                            const ClusterScanArgs& a,
                                            long long base, int t, int nt) {
  for (int i = t; i < kChunk; i += nt) {
    const long long k = base + i;
    if (k < a.n) {
      st.arr[i] = a.arr[k];
      st.ti[i] = a.ti[k];
      st.slac[i] = a.slac[k];
      st.slar[i] = a.slar[k];
      st.prio[i] = a.prio[k];
      st.od[i] = a.od[k];
      st.al[i] = a.al[k];
      st.flags[i] = (a.has[k] ? 1 : 0) | (a.degr[k] ? 2 : 0);
    }
  }
}

// Brings the 128-byte line that holds p into L1.
__device__ __forceinline__ void prefetch_line(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(
      reinterpret_cast<uintptr_t>(p) & ~uintptr_t{127}));
}

// Victim rows of requests [base, base + kChunk) to -1, and the chunk's
// selection and CDF rows prefetched into L1.
__device__ __forceinline__ void prepare_chunk(const ClusterScanArgs& a,
                                              long long base, int t,
                                              int nt) {
  const long long end = min(base + kChunk, a.n);
  if (a.has_budget) {
    const long long E = (long long)a.R * a.K;
    for (long long k = base * E + t; k < end * E; k += nt) {
      a.vict1[k] = -1;
      a.vict2[k] = -1;
    }
  }
  const char* sel = reinterpret_cast<const char*>(a.sel + base * a.R);
  const long long sel_bytes = (end - base) * a.R * 4;
  for (long long b = (long long)t * 128; b < sel_bytes; b += nt * 128)
    prefetch_line(sel + b);
  if (a.cdf != nullptr) {
    const long long row = (long long)a.R * a.K;
    const char* cdf = reinterpret_cast<const char*>(a.cdf + base * row);
    const long long cdf_bytes = (end - base) * row * 8;
    for (long long b = (long long)t * 128; b < cdf_bytes; b += nt * 128)
      prefetch_line(cdf + b);
  }
}

// One replica submit (SimReplicaStack.submit through the ClusterPlacer)
// on replica j for request i, masked by `on`; victims go to vict (E
// ints, -1 filled) when there is a budget.
__device__ __forceinline__ Leg leg(State& s, const ClusterScanArgs& a,
                                   long long i, int j, bool on, double arr,
                                   double ti, long long budget, int* vict) {
  const int K = a.K;
  const int E = a.R * K;
  const int kindj = a.kind[j];
  int sel;
  if (kindj == 1) {
    // cnnselect: searchsorted right, as the count of CDF entries <= u.
    const double uu =
        a.u[j * a.u_cols + min((long long)s.up[j], a.u_cols - 1)];
    const double* row = a.cdf + (i * a.R + j) * K;
    sel = 0;
    for (int k = 0; k < K; ++k) sel += row[k] <= uu;
  } else if (kindj == 2) {
    sel = a.ri[j * a.ri_cols + min((long long)s.up[j], a.ri_cols - 1)];
  } else {
    sel = a.sel[i * a.R + j];
  }
  if (on && kindj != 0) s.up[j] += 1;
  const int flat = j * K + sel;
  const bool need = on && !s.hot[flat];
  if (a.has_budget && need) {
    const long long size = a.sizes[flat];
    int cnt = 0;
    while (s.hb + size > budget) {
      // The first argmin of where(hot & (e != flat), last, inf).
      bool any = false;
      int v = 0;
      double m = 0.0;
      for (int e = 0; e < E; ++e) {
        const bool cand = s.hot[e] && e != flat;
        const double val = cand ? s.last[e] : __longlong_as_double(
                                                  0x7ff0000000000000LL);
        any |= cand;
        if (e == 0 || val < m) {
          m = val;
          v = e;
        }
      }
      if (!any) break;
      s.hot[v] = false;
      vict[cnt++] = v;
      s.hb -= a.sizes[v];
    }
  }
  if (on) {
    s.last[flat] = arr;
    s.hot[flat] = true;
  }
  if (need) s.hb += a.sizes[flat];
  const double xmu = a.xmu[flat];
  const int needs_z = (need && xmu > 0.0) ? 1 : 0;
  const double* zr = a.z + (long long)j * 2 * a.n;
  const int zp = s.zp[j];
  const long long zlast = 2 * a.n - 1;
  const double zc = zr[min((long long)zp, zlast)];
  double startup = 0.0;
  if (need) {
    if (xmu > 0.0) {
      const double c = __dadd_rn(xmu, __dmul_rn(a.xsgp[flat], zc));
      startup = c > 0.0 ? c : 0.0;
    } else {
      startup = xmu;
    }
  }
  const double ze = zr[min((long long)zp + needs_z, zlast)];
  if (on) s.zp[j] = zp + 1 + needs_z;
  const double drawn = __dadd_rn(a.mu[flat], __dmul_rn(a.sgp[flat], ze));
  const double floor_ = a.p1mu[flat];
  const double exc =
      __dadd_rn((drawn > floor_ ? drawn : floor_) / a.speed[j], startup);
  const double arrive = arr + ti;
  const double fj = s.free[j];
  const double start = arrive > fj ? arrive : fj;
  const double queue = start - arrive;
  if (on) s.free[j] = start + exc;
  const double e2e = __dadd_rn(__dadd_rn(__dmul_rn(2.0, ti), queue), exc);
  return Leg{sel, flat, need, queue, exc, e2e};
}

// The placement's first index of the lexmin (delay, -capacity) among the
// entries of `dm` equal to its minimum `md` (the reference's
// argmax(m & (cm == max(cm))) with cm = where(m, cap, -inf)), skipping
// index `skip` (as +inf) when it is >= 0.
__device__ __forceinline__ int place(const double* free, const double* cap,
                                     int R, int n_on, double arrive,
                                     double md, int skip) {
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  int j = -1;
  double best = 0.0;
  for (int r = 0; r < R; ++r) {
    double d = inf;
    if (r < n_on && r != skip) {
      const double x = free[r] - arrive;
      d = x > 0.0 ? x : 0.0;
    }
    if (d == md && (j < 0 || cap[r] > best)) {
      best = cap[r];
      j = r;
    }
  }
  return j < 0 ? 0 : j;
}

// The least queue delay over the first n_on replicas (+inf if none),
// with index `skip` counted as +inf when it is >= 0.
__device__ __forceinline__ double least_delay(const double* free, int R,
                                              int n_on, double arrive,
                                              int skip) {
  double md = __longlong_as_double(0x7ff0000000000000LL);
  for (int r = 0; r < min(n_on, R); ++r) {
    if (r == skip) continue;
    const double x = free[r] - arrive;
    const double d = x > 0.0 ? x : 0.0;
    if (d < md) md = d;
  }
  return md;
}

__global__ void __launch_bounds__(kThreads)
    cluster_scan_kernel(const ClusterScanArgs a) {
  __shared__ Stage stages[2];
  __shared__ double sh_free[kSharedReplicas];
  __shared__ int sh_up[kSharedReplicas];
  __shared__ int sh_zp[kSharedReplicas];
  __shared__ double sh_last[kSharedEntries];
  __shared__ bool sh_hot[kSharedEntries];
  const int R = a.R;
  const int E = R * a.K;
  const bool in_shared = R <= kSharedReplicas && E <= kSharedEntries;
  State s{in_shared ? sh_free : a.free_out, in_shared ? sh_hot : a.hot_out,
          in_shared ? sh_last : a.last_out, in_shared ? sh_up : a.up_out,
          in_shared ? sh_zp : a.zp_out, 0};
  const int t = threadIdx.x;
  for (int r = t; r < R; r += blockDim.x) {
    s.free[r] = a.free0[r];
    s.up[r] = a.up0[r];
    s.zp[r] = a.zp0[r];
  }
  for (int e = t; e < E; e += blockDim.x) {
    s.hot[e] = a.hot0[e];
    s.last[e] = a.last0[e];
  }
  const long long chunks = (a.n + kChunk - 1) / kChunk;
  stage_chunk(stages[0], a, 0, t, blockDim.x);
  prepare_chunk(a, 0, t, blockDim.x);
  __syncthreads();
  if (t == 0) {
    s.hb = *a.hb0;
  }
  const long long budget = *a.budget;
  const int min_active = *a.min_active;
  const bool hedge = *a.hedge;
  const double shed_factor = *a.shed_factor;
  const double headroom = *a.headroom;
  int n_act = *a.n_act0;
  for (long long c = 0; c < chunks; ++c) {
    const Stage& cur = stages[c & 1];
    if (t >= 32) {
      if (c + 1 < chunks) {
        stage_chunk(stages[(c + 1) & 1], a, (c + 1) * kChunk, t - 32,
                    blockDim.x - 32);
        prepare_chunk(a, (c + 1) * kChunk, t - 32, blockDim.x - 32);
      }
    } else if (t == 0) {
      const long long base = c * kChunk;
      const int len = (int)min((long long)kChunk, a.n - base);
      for (int li = 0; li < len; ++li) {
        const long long i = base + li;
        const double arr = cur.arr[li];
        const double ti = cur.ti[li];
        const double slac = cur.slac[li];
        // 1. controller-alarm scale.
        const int al = cur.al[li];
        const int want = min(max(n_act + (al > 0) - (al < 0), min_active), R);
        const bool do1 = al != 0 && want != n_act;
        const int n1 = do1 ? want : n_act;
        // 2-3. active-prefix queue delays, sustained-queueing scale-up.
        const double arrive = arr + ti;
        const double md1 = least_delay(s.free, R, n1, arrive, -1);
        const bool grow = md1 > __dmul_rn(headroom, slac) && n1 < R;
        const int n2 = n1 + (grow ? 1 : 0);
        const double md2 = least_delay(s.free, R, n2, arrive, -1);
        // 4. SLA-class-priority shed.
        const double od = cur.od[li];
        const double thresh =
            __dmul_rn(__dmul_rn(shed_factor, slac), 1.0 + cur.prio[li]);
        const bool shed = md2 > thresh && od > 0.0 &&
                          (od <= slac || md2 > __dmul_rn(2.0, thresh));
        // 5. placement order and the runner-up.
        const int j1 = place(s.free, a.cap, R, n2, arrive, md2, -1);
        const double md2b = least_delay(s.free, R, n2, arrive, j1);
        const int j2 = place(s.free, a.cap, R, n2, arrive, md2b, j1);
        const bool degr = cur.flags[li] & 2;
        const bool do_hedge = !shed && degr && hedge && n2 > 1;
        // 6-7. the two legs (leg 2 sees leg 1's queues).
        int* v1 = a.has_budget ? a.vict1 + i * E : nullptr;
        int* v2 = a.has_budget ? a.vict2 + i * E : nullptr;
        const Leg l1 = leg(s, a, i, j1, !shed, arr, ti, budget, v1);
        Leg l2{0, 0, false, 0.0, 0.0, 0.0};
        if (do_hedge) l2 = leg(s, a, i, j2, true, arr, ti, budget, v2);
        // 8. strict first-completion-wins.
        const bool win2 = do_hedge && l2.e2e < l1.e2e;
        const double e2ew = win2 ? l2.e2e : l1.e2e;
        a.scale1[i] = do1 ? n1 : -1;
        a.scale2[i] = grow ? n2 : -1;
        a.shed[i] = shed;
        a.hedged[i] = do_hedge;
        a.j1[i] = j1;
        a.sel1[i] = l1.sel;
        a.place1[i] = l1.need;
        a.j2[i] = j2;
        a.sel2[i] = l2.sel;
        a.place2[i] = l2.need;
        a.jw[i] = win2 ? j2 : j1;
        a.flatw[i] = win2 ? l2.flat : l1.flat;
        a.qw[i] = win2 ? l2.queue : l1.queue;
        a.xw[i] = win2 ? l2.exc : l1.exc;
        a.e2ew[i] = e2ew;
        a.okw[i] = (cur.flags[li] & 1) ? e2ew <= cur.slar[li] : true;
        n_act = n2;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    *a.hb_out = s.hb;
    *a.n_act_out = n_act;
  }
  if (in_shared) {
    for (int r = t; r < R; r += blockDim.x) {
      a.free_out[r] = s.free[r];
      a.up_out[r] = s.up[r];
      a.zp_out[r] = s.zp[r];
    }
    for (int e = t; e < E; e += blockDim.x) {
      a.hot_out[e] = s.hot[e];
      a.last_out[e] = s.last[e];
    }
  }
}

}  // namespace

// The scan over a->n requests on `stream` (see ClusterScanArgs): every
// output column and the final carry. R >= 1, K >= 1 and n >= 1.
extern "C" int cluster_scan_fwd(const ClusterScanArgs* args, void* stream) {
  if (args->R < 1 || args->K < 1 || args->n < 1 || args->u_cols < 1 ||
      args->ri_cols < 1)
    return cudaErrorInvalidValue;
  cluster_scan_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return cudaGetLastError();
}

// The size of ClusterScanArgs, which the ctypes mirror checks.
extern "C" int cluster_scan_args_size() {
  return (int)sizeof(ClusterScanArgs);
}
