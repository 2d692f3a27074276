// Hoyer projection for Hopper (sm_90a), float and double:
//   for each vector s (length N) find v minimizing ||v - s||
//   with sum(v) = k1, sum(v^2) = k2, v >= 0 (projfunc.m, Hoyer 2004),
//   in at most `passes` passes, each vector stopping once it is done.
//
// It replaces no pallas_call.  It stands for the device loops of the JAX
// package's projection: the lax.while_loop of project_columns
// (nmf_toolbox_tpu/ops/projection.py:55-58,89), which ops/projection.py
// project_rows runs through it on a card with a budget of N + 1 passes,
// and the lax.fori_loop of _project_columns_bounded
// (nmf_toolbox_tpu/models/nmfsc_phased.py:70), project_rows_bounded's.
// In eager PyTorch one pass is ~25 launching ops; here a whole
// projection is one launch that reads nothing back.
//
// Bound on the H100: bytes, one read of S and one write of v at
// 3.35 TB/s; a pass is ~12 operations an entry, under the SIMT peak for
// the passes these inputs take (what limits the kernel is its instruction
// rate and how much of a long vector set the registers hold, PERF.md).
// So each vector is read once, kept on chip for every pass and written
// once:
//   * register tiers: THREADS threads of a CTA hold ITEMS entries each
//     in registers, a zeroed entry as -0.0 (no mask register).  A short
//     vector has a CTA of its own; a long one a thread-block cluster of
//     as many CTAs as its length needs (at most CLUSTER), each holding a
//     contiguous slice;
//   * each half-pass packs its sums (sum w^2 and sum w; then the
//     threads that hold a negative entry, the count of zeroed entries
//     and the sum of the clamped vector) into one reduction:
//     warp shuffles, one __syncthreads, and every warp adds the warps'
//     partials in the same order; in a cluster the CTAs' totals then go
//     through distributed shared memory behind one cluster barrier and
//     every warp of every CTA adds the ranks' totals in rank order.  No
//     atomics: every CTA and every rerun gets identical bits.  Each
//     reduction writes the scratch half of its parity, so the next one
//     needs no barrier before it writes;
//   * the streaming tier, for vectors longer than the largest cluster
//     holds, is one CTA per vector over global memory (three sweeps a
//     pass): v lives in the output buffer, a zeroed entry as -0.0 there
//     too, a value no live entry takes;
//   * a vector leaves its pass loop as soon as it is done, which is
//     exact: a pass over a done vector changes nothing;
//   * a vector's entries are contiguous and load and store at constant
//     offsets; vectors may lie at any batch strides.  The wrapper copies
//     strided entries (W's columns as rows of W.mT) contiguous first:
//     read in place, a warp uses 4 or 8 bytes of each 32-byte sector,
//     which is slower (PERF.md).
// One table (NMF_HOYER_TIERS_F32 / _F64, read by nmf_hoyer_tier) chooses
// the tier by length and dtype; a build may define its own table (the
// CPU tests build small ones).  The per-pass arithmetic is that of
// ops/projection.py _pass, its cancellation-free root included
// (v + alpha w = mid + beta w), its clamp_min and its NaN passthrough.

#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include <mutex>

// X(threads per CTA, entries per thread, CTAs per cluster at most), in
// order of capacity (threads * entries * CTAs).  A cluster tier gives a
// vector of length N ceil(N / (threads * entries)) CTAs.  Vectors longer
// than the last tier holds take the streaming tier.
#ifndef NMF_HOYER_TIERS_F32
#define NMF_HOYER_TIERS_F32(X) \
  X(128, 8, 1) X(256, 8, 1) X(512, 16, 1) X(1024, 16, 1) X(128, 128, 16)
#endif
#ifndef NMF_HOYER_TIERS_F64
#define NMF_HOYER_TIERS_F64(X) \
  X(128, 8, 1) X(256, 8, 1) X(512, 16, 1) X(1024, 16, 1) X(128, 64, 16)
#endif
#ifndef NMF_HOYER_STREAM_THREADS
#define NMF_HOYER_STREAM_THREADS 1024
#endif

namespace {

namespace cg = cooperative_groups;

constexpr unsigned FULL = 0xffffffffu;
constexpr int PORTABLE_CLUSTER = 8;  // larger clusters need the non-portable opt-in
constexpr int MAX_DEVICES = 64;      // cards a process may launch on

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// A zeroed entry: -0.0.
__device__ __forceinline__ bool neg_zero(float x) { return __float_as_uint(x) == 0x80000000u; }
__device__ __forceinline__ bool neg_zero(double x) {
  return (unsigned long long)__double_as_longlong(x) == 0x8000000000000000ull;
}

// CTAs per SM a register tier asks the compiler to leave room for: its
// entries' registers (ITEMS of T a thread) and ~40 more, in 64 K.
template <typename T>
__host__ __device__ constexpr int min_ctas(int threads, int items) {
  const int regs = items * (int)(sizeof(T) / 4) + 40;
  const int ctas = 65536 / (threads * regs);
  return ctas < 1 ? 1 : ctas;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  // Butterfly: every lane ends with the same bits (a + b == b + a).
  for (int o = 16; o > 0; o >>= 1) x += (T)__shfl_xor_sync(FULL, x, o);
  return x;
}

// Where a vector lies: S and v as (B0, B1, N) with batch strides s0, s1
// (v: v0, v1), in elements, and contiguous entries.
struct Layout {
  long long B1, s0, s1, v0, v1;
  int N, valid;  // entries past `valid` start zeroed
};

// k1 and k2: a value each, or a pointer read at b * stride (stride 0:
// one value on the device for every vector).
template <typename T>
struct Targets {
  const T *k1, *k2;
  long long k1s, k2s;
  T k1v, k2v;
};

// The sums of a, b and c over the CTA (CLUSTER == 1) or the cluster, in
// a fixed order, returned to every thread with the same bits.  part
// (2 x WARPS x 3) and cpart (2 x 3) are the CTA's shared scratch; a call
// writes the half of its parity, which is written again two calls later,
// after every thread has passed the barrier of the call between.
template <typename T, int THREADS, int CLUSTER>
struct Reducer {
  static constexpr int WARPS = THREADS / 32;
  static constexpr int SCRATCH = 2 * WARPS * 3 + 2 * 3;  // T values
  T* part;
  T* cpart;
  int ranks;  // the cluster's CTAs, at most CLUSTER
  int parity;

  __device__ __forceinline__ void sum3(T& a, T& b, T& c) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    T* p = part + parity * WARPS * 3;
    a = warp_sum(a);
    b = warp_sum(b);
    c = warp_sum(c);
    if (lane == 0) {
      p[warp * 3] = a;
      p[warp * 3 + 1] = b;
      p[warp * 3 + 2] = c;
    }
    __syncthreads();
    a = warp_sum(lane < WARPS ? p[lane * 3] : T(0));
    b = warp_sum(lane < WARPS ? p[lane * 3 + 1] : T(0));
    c = warp_sum(lane < WARPS ? p[lane * 3 + 2] : T(0));
    if constexpr (CLUSTER > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      T* q = cpart + parity * 3;
      if (threadIdx.x == 0) {
        q[0] = a;
        q[1] = b;
        q[2] = c;
      }
      cluster.sync();  // release / acquire: every rank's q is visible
      const T* r = cluster.map_shared_rank(q, (unsigned)(lane % ranks));
      a = warp_sum(lane < ranks ? r[0] : T(0));
      b = warp_sum(lane < ranks ? r[1] : T(0));
      c = warp_sum(lane < ranks ? r[2] : T(0));
    }
    parity ^= 1;
  }
};

template <typename T, int THREADS, int CLUSTER>
__device__ __forceinline__ Reducer<T, THREADS, CLUSTER> make_reducer(unsigned char* smem,
                                                                    int ranks) {
  T* base = reinterpret_cast<T*>(smem);
  return {base, base + 2 * (THREADS / 32) * 3, ranks, 0};
}

__device__ __forceinline__ long long vec_offset(long long b, long long B1, long long s0,
                                                long long s1) {
  return (b / B1) * s0 + (b % B1) * s1;
}

// The register tiers: one CTA (CLUSTER == 1) or one cluster per vector.
// A zeroed entry is held as -0.0, as the streaming tier stores it: no
// mask register, one integer compare to test it, and `+ 0` at the store
// makes it +0.0.  The CTAs' slots past N count as zeroed entries from the
// start, like the pad past `valid`: they add 0 to every sum, so a pass
// needs no test of which slots hold entries, and n_all counts them
// (n_all - nz is the plain version's N - nz).  Per entry a pass is a
// handful of instructions: sum w and w^2 (sum w*mid is mid * sum w, sum
// mid^2 the count times mid^2), v_proj, its sign tests, the clamped sum
// and the count of zeroed entries; the negative test is one flag a
// thread.
template <typename T, int THREADS, int ITEMS, int CLUSTER>
__global__ void __launch_bounds__(THREADS, min_ctas<T>(THREADS, ITEMS))
hoyer_tile_kernel(const T* __restrict__ S, T* __restrict__ v,
                  unsigned char* __restrict__ done_out, int* __restrict__ iters_out,
                  Layout L, Targets<T> kt, int passes) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps, at most 1024 threads");
  static_assert(CLUSTER >= 1 && CLUSTER <= 16, "at most 16 CTAs per cluster");
  extern __shared__ __align__(16) unsigned char hoyer_smem[];
  int rank = 0, ranks = 1;
  if constexpr (CLUSTER > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    ranks = (int)cluster.num_blocks();
    if (ranks > CLUSTER) __trap();  // a launch this instance was not built for
    rank = (int)cluster.block_rank();
  }
  auto red = make_reducer<T, THREADS, CLUSTER>(hoyer_smem, ranks);
  const long long b = blockIdx.x / ranks;
  const T* s = S + vec_offset(b, L.B1, L.s0, L.s1);
  T* out = v + vec_offset(b, L.B1, L.v0, L.v1);
  const T k1 = kt.k1 ? kt.k1[b * kt.k1s] : kt.k1v;
  const T k2 = kt.k2 ? kt.k2[b * kt.k2s] : kt.k2v;
  const int N = L.N, valid = L.valid;
  const int first = rank * (THREADS * ITEMS) + (int)threadIdx.x;
  const T zeroed = -T(0);

  // Read once: entry first + j * THREADS is x[j] (a pad, or a slot past
  // N, starts zeroed).
  T x[ITEMS];
  T sum = 0, u = 0, w = 0;
  const T* sp = s + first;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) x[j] = first + j * THREADS < valid ? sp[j * THREADS] : zeroed;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (first + j * THREADS < valid) sum += x[j];
  // Onto the sum hyperplane (projfunc.m:22), over the valid entries; no
  // entry stays -0.0 (x + shift is -0.0 only for x = shift = -0.0).
  red.sum3(sum, u, w);
  const T shift = (k1 - sum) / T(valid);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (first + j * THREADS < valid) x[j] += shift;

  const T n_all = T(ranks * THREADS * ITEMS);
  T nz = n_all - T(valid);  // zeroed entries: an exact count in T
  bool done = false;
  int p = 0;
  for (; p < passes && !done; ++p) {
    // To the L2 sphere along the hyperplane from its midpoint
    // (projfunc.m:31-38), in _pass's cancellation-free form.
    const T mid = k1 / (n_all - nz);
    T a = 0, sd = 0, unused = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const T d = neg_zero(x[j]) ? T(0) : x[j] - mid;
      a += d * d;
      sd += d;
    }
    red.sum3(a, sd, unused);
    const T sw = mid * sd;
    const T q = k2 - (n_all - nz) * mid * mid;
    T disc = sw * sw + a * q;
    disc = disc < T(0) ? T(0) : disc;  // clamp_min: a NaN stays NaN
    const T beta = (-sw + root(disc)) / a;

    // Done when no entry is negative (projfunc.m:40-44); else zero the
    // non-positive ones and redistribute (projfunc.m:49-53).  x takes
    // v_proj, -0.0 where zeroed (a done vector's are +0.0 once stored).
    bool neg = false;
    int zeros = 0;
    T scl = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const bool was = neg_zero(x[j]);
      const T m = was ? T(0) : mid;
      const T vp = beta * (x[j] - m) + m;
      neg |= !(vp >= T(0));
      const bool zz = was || vp <= T(0);
      zeros += zz;
      scl += zz ? T(0) : vp;
      x[j] = zz ? zeroed : vp;
    }
    T negs = neg, nz2 = T(zeros);
    red.sum3(negs, nz2, scl);
    if (negs == T(0)) {
      done = true;
    } else {
      const T corr = (k1 - scl) / (n_all - nz2);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        if (!neg_zero(x[j])) x[j] += corr;
      nz = nz2;
    }
  }
  // Written once, zeroed entries as +0.0.
  T* op = out + first;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (first + j * THREADS < N) op[j * THREADS] = x[j] + T(0);
  if (rank == 0 && threadIdx.x == 0) {
    done_out[b] = done;
    iters_out[b] = p;
  }
  // A CTA's scratch must outlive the other ranks' reads of it.
  if constexpr (CLUSTER > 1) cg::this_cluster().sync();
}

// The streaming tier: one CTA per vector over global memory.
template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
hoyer_stream_kernel(const T* __restrict__ S, T* __restrict__ v,
                    unsigned char* __restrict__ done_out, int* __restrict__ iters_out,
                    Layout L, Targets<T> kt, int passes) {
  extern __shared__ __align__(16) unsigned char hoyer_smem[];
  auto red = make_reducer<T, THREADS, 1>(hoyer_smem, 1);
  const long long b = blockIdx.x;
  const T* s = S + vec_offset(b, L.B1, L.s0, L.s1);
  T* x = v + vec_offset(b, L.B1, L.v0, L.v1);
  const T k1 = kt.k1 ? kt.k1[b * kt.k1s] : kt.k1v;
  const T k2 = kt.k2 ? kt.k2[b * kt.k2s] : kt.k2v;
  const int N = L.N, valid = L.valid, t = threadIdx.x;
  const T zeroed = -T(0);

  T sum = 0, u = 0, w = 0;
  for (int i = t; i < valid; i += THREADS) sum += s[i];
  red.sum3(sum, u, w);
  const T shift = (k1 - sum) / T(valid);
  for (int i = t; i < N; i += THREADS) x[i] = i < valid ? s[i] + shift : zeroed;

  const T n_all = T(N);
  T nz = T(N - valid);
  bool done = false;
  int p = 0;
  for (; p < passes && !done; ++p) {
    const T mid = k1 / (n_all - nz);
    T a = 0, sw = 0, mm = 0;
    for (int i = t; i < N; i += THREADS) {
      const T xi = x[i];
      const T m = neg_zero(xi) ? T(0) : mid;
      const T d = xi - m;
      a += d * d;
      sw += d * m;
      mm += m * m;
    }
    red.sum3(a, sw, mm);
    const T q = k2 - mm;
    T disc = sw * sw + a * q;
    disc = disc < T(0) ? T(0) : disc;
    const T beta = (-sw + root(disc)) / a;

    // v takes v_proj here, and -0.0 where zeroed; a done vector's -0.0
    // become +0.0 at the end.
    T neg = 0, nz2 = 0, scl = 0;
    for (int i = t; i < N; i += THREADS) {
      const T xi = x[i];
      const bool zi = neg_zero(xi);
      const T m = zi ? T(0) : mid;
      const T vp = beta * (xi - m) + m;
      const bool zz = zi || vp <= T(0);
      neg += !(vp >= T(0));
      nz2 += zz;
      scl += zz ? T(0) : vp;
      x[i] = zz ? zeroed : vp;
    }
    red.sum3(neg, nz2, scl);
    if (neg == T(0)) {
      done = true;
    } else {
      const T corr = (k1 - scl) / (n_all - nz2);
      for (int i = t; i < N; i += THREADS) {
        const T xi = x[i];
        if (!neg_zero(xi)) x[i] = xi + corr;
      }
      nz = nz2;
    }
  }
  for (int i = t; i < N; i += THREADS)
    if (neg_zero(x[i])) x[i] = T(0);
  if (t == 0) {
    done_out[b] = done;
    iters_out[b] = p;
  }
}

// Launch one CTA (CLUSTER == 1) or a cluster of `ranks` <= CLUSTER CTAs
// per vector.
template <typename T, int THREADS, int CLUSTER, typename Kernel>
cudaError_t launch_on(Kernel kernel, int ranks, const T* S, T* v, unsigned char* done,
                      int* iters, long long B, const Layout& L, const Targets<T>& kt,
                      int passes, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * ranks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Reducer<T, THREADS, CLUSTER>::SCRATCH * sizeof(T);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (CLUSTER > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // Once per card, kernel and cluster size: the opt-in past 8 CTAs (an
    // attribute of the kernel in the current card's context), and whether
    // that card can place one such cluster at all (it cannot: the launch
    // would fail).  Under a lock: threads may launch on several cards.
    static std::mutex lock;
    static bool known[MAX_DEVICES][CLUSTER + 1];
    static cudaError_t placeable[MAX_DEVICES][CLUSTER + 1];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidValue;
    {
      std::lock_guard<std::mutex> hold(lock);
      if (!known[dev][ranks]) {
        if (CLUSTER > PORTABLE_CLUSTER)
          e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        int clusters = 0;
        if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (e == cudaSuccess && clusters < 1) e = cudaErrorInvalidConfiguration;
        placeable[dev][ranks] = e;
        known[dev][ranks] = true;
      }
      e = placeable[dev][ranks];
    }
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, S, v, done, iters, L, kt, passes);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// CTAs a vector of length N takes in a tier of `per_cta` entries a CTA.
inline int ranks_for(int N, int per_cta) { return (N + per_cta - 1) / per_cta; }

template <typename T, int THREADS, int ITEMS, int CLUSTER>
cudaError_t launch_tile(const T* S, T* v, unsigned char* done, int* iters, long long B,
                        const Layout& L, const Targets<T>& kt, int passes, cudaStream_t st) {
  return launch_on<T, THREADS, CLUSTER>(hoyer_tile_kernel<T, THREADS, ITEMS, CLUSTER>,
                                        ranks_for(L.N, THREADS * ITEMS), S, v, done, iters,
                                        B, L, kt, passes, st);
}

#define NMF_HOYER_LAUNCH(TH, IT, CL)                                         \
  if (L.N <= (long long)(TH) * (IT) * (CL))                                  \
    return launch_tile<T, TH, IT, CL>(S, v, done, iters, B, L, kt, passes, st);

template <typename T>
cudaError_t dispatch(const T* S, T* v, unsigned char* done, int* iters, long long B,
                     const Layout& L, const Targets<T>& kt, int passes, cudaStream_t st) {
  if constexpr (sizeof(T) == 8) {
    NMF_HOYER_TIERS_F64(NMF_HOYER_LAUNCH)
  } else {
    NMF_HOYER_TIERS_F32(NMF_HOYER_LAUNCH)
  }
  return launch_on<T, NMF_HOYER_STREAM_THREADS, 1>(
      hoyer_stream_kernel<T, NMF_HOYER_STREAM_THREADS>, 1, S, v, done, iters, B, L, kt,
      passes, st);
}

#undef NMF_HOYER_LAUNCH

template <typename T>
int project(const void* S, void* v, void* done, void* iters, long long B, Layout L,
            const void* k1, long long k1s, double k1v, const void* k2, long long k2s,
            double k2v, int passes, void* stream) {
  Targets<T> kt{static_cast<const T*>(k1), static_cast<const T*>(k2), k1s, k2s, (T)k1v,
                (T)k2v};
  return dispatch(static_cast<const T*>(S), static_cast<T*>(v),
                  static_cast<unsigned char*>(done), static_cast<int*>(iters), B, L, kt,
                  passes, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// The tier for vectors of length N: its index in the table (the
// streaming tier after the last register tier), with info[0..2] = its
// threads per CTA, entries per thread (0 for the streaming tier) and the
// CTAs a vector of length N takes; -1 for N < 1.
int nmf_hoyer_tier(int N, int is_double, int* info) {
  if (N < 1) return -1;
  int tier = 0;
#define NMF_HOYER_TIER(TH, IT, CL)                 \
  if (N <= (long long)(TH) * (IT) * (CL)) {        \
    info[0] = TH;                                  \
    info[1] = IT;                                  \
    info[2] = ranks_for(N, (TH) * (IT));           \
    return tier;                                   \
  }                                                \
  ++tier;
  if (is_double) {
    NMF_HOYER_TIERS_F64(NMF_HOYER_TIER)
  } else {
    NMF_HOYER_TIERS_F32(NMF_HOYER_TIER)
  }
#undef NMF_HOYER_TIER
  info[0] = NMF_HOYER_STREAM_THREADS;
  info[1] = 0;
  info[2] = 1;
  return tier;
}

// Project the B vectors of S, seen as (B0, B1, N) with B = B0 * B1,
// batch strides s0, s1 (elements) and contiguous entries, into v (batch
// strides v0, v1), in at most `passes` passes: done (B bytes) and iters
// (B ints) get each vector's flag and pass count.  Entries at or past
// `valid` (1 <= valid <= N) start zeroed and the hyperplane step divides
// by `valid`.  k1: the device array at k1 (element b * k1s for vector
// b; k1s = 0 for one value), or k1v where k1 is null; k2 likewise.
// is_double selects double over float.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for B < 1, N < 1, valid out of range or
// passes < 0; the error of a cluster the card cannot place).
int nmf_hoyer_project(const void* S, void* v, void* done, void* iters, long long B,
                      long long B1, int N, int valid, long long s0, long long s1,
                      long long v0, long long v1, const void* k1, long long k1s,
                      double k1v, const void* k2, long long k2s, double k2v, int passes,
                      int is_double, void* stream) {
  if (B < 1 || B1 < 1 || B % B1 != 0 || N < 1 || valid < 1 || valid > N || passes < 0 ||
      B > 0x7fffffffLL / 16)
    return cudaErrorInvalidValue;
  Layout L{B1, s0, s1, v0, v1, N, valid};
  if (is_double)
    return project<double>(S, v, done, iters, B, L, k1, k1s, k1v, k2, k2s, k2v, passes,
                           stream);
  return project<float>(S, v, done, iters, B, L, k1, k1s, k1v, k2, k2s, k2v, passes, stream);
}

}  // extern "C"
