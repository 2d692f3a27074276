// Bounded Hoyer projection for Hopper (sm_90a), float and double:
//   for each vector s (a row of S, length N) find v minimizing ||v - s||
//   with sum(v) = k1, sum(v^2) = k2, v >= 0 (projfunc.m, Hoyer 2004),
//   in at most `passes` passes.
//
// It replaces no pallas_call.  It stands for the lax.fori_loop of
// _project_columns_bounded (nmf_toolbox_tpu/models/nmfsc_phased.py:70),
// which XLA runs on the device inside the phased dispatch's one program
// per iteration.  In eager PyTorch one pass of the projection is ~25
// launching ops (ops/projection.py _pass), so the phased iteration, 2
// phases x 24 bounded trials x 48 passes, would launch ~57 000 ops; here
// a whole bounded projection is one launch that reads nothing back.
//
// Bound on the H100: bytes.  One read of S and one write of v at
// 3.35 TB/s; the passes re-read v and the zero mask, which stay in L2 at
// the phased solver's widths.  This first version is a simple
// global-memory kernel; keeping a vector in shared memory is later work.
//
// Design:
//   * one block per vector (the grid is the product of S's batch axes),
//     THREADS threads striding over its N entries, so every entry is
//     read and written by one thread and a pass needs no barrier but
//     those of its sums;
//   * each pass takes its six per-vector sums (sum w^2, sum w*mid,
//     sum mid^2; then the count of negative entries, the count of zeroed
//     entries and the sum of the clamped vector) in T, each thread over
//     its own entries in order, then by warp shuffles and a fixed
//     shared-memory tree, with no atomics: reruns give identical bits;
//   * v lives in the output buffer, the zero mask in a byte scratch;
//   * the block leaves its pass loop as soon as its vector is done,
//     which is exact: a pass over a done vector changes nothing
//     (nmfsc_phased.py:71-79); it writes its done flag and pass count.
// The per-pass arithmetic is that of ops/projection.py _pass, the
// port's cancellation-free root included (v + alpha w = mid + beta w).
// Rows must be contiguous: the wrapper (ops/kernels/hoyer.py) copies a
// strided view (W's columns, rows of W.mT) into a contiguous buffer
// first, which costs one read and write of a small factor.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LONG_N = 16384;  // vectors at least this long get 1024 threads

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  // Butterfly: every lane ends with the same bits (a + b == b + a).
  for (int o = 16; o > 0; o >>= 1) x += (T)__shfl_xor_sync(FULL, x, o);
  return x;
}

// The block's sums of a, b and c, in a fixed order, returned to every
// thread.  part and total are the block's shared scratch.
template <typename T, int THREADS>
__device__ __forceinline__ void block_sum3(T& a, T& b, T& c, T (*part)[3], T* total) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  if (lane == 0) {
    part[warp][0] = a;
    part[warp][1] = b;
    part[warp][2] = c;
  }
  __syncthreads();
  if (warp == 0) {
    T x = lane < WARPS ? part[lane][0] : T(0);
    T y = lane < WARPS ? part[lane][1] : T(0);
    T z = lane < WARPS ? part[lane][2] : T(0);
    x = warp_sum(x);
    y = warp_sum(y);
    z = warp_sum(z);
    if (lane == 0) {
      total[0] = x;
      total[1] = y;
      total[2] = z;
    }
  }
  __syncthreads();
  // The next call writes part before its first barrier and total after
  // it, when every thread has read these.
  a = total[0];
  b = total[1];
  c = total[2];
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
hoyer_project_kernel(const T* __restrict__ S, T* __restrict__ v,
                     unsigned char* __restrict__ zero, unsigned char* __restrict__ done_out,
                     int* __restrict__ iters_out, int N, int passes, T k1, T k2) {
  __shared__ T part[THREADS / 32][3];
  __shared__ T total[3];
  const long long off = (long long)blockIdx.x * N;
  const T* s = S + off;
  T* x = v + off;
  unsigned char* z = zero + off;
  const int t = threadIdx.x;
  const T n_all = (T)N;

  // Onto the sum hyperplane (projfunc.m:22).
  T sum = 0, u = 0, w = 0;
  for (int i = t; i < N; i += THREADS) sum += s[i];
  block_sum3<T, THREADS>(sum, u, w, part, total);
  const T shift = (k1 - sum) / n_all;
  for (int i = t; i < N; i += THREADS) {
    x[i] = s[i] + shift;
    z[i] = 0;
  }

  T nz = 0;  // zeroed entries: an exact count in T, as _pass keeps it
  bool done = false;
  int p = 0;
  for (; p < passes && !done; ++p) {
    // To the L2 sphere along the hyperplane from its midpoint
    // (projfunc.m:31-38), in _pass's cancellation-free form.
    const T mid = k1 / (n_all - nz);
    T a = 0, sw = 0, mm = 0;
    for (int i = t; i < N; i += THREADS) {
      const T m = z[i] ? T(0) : mid;
      const T d = x[i] - m;
      a += d * d;
      sw += d * m;
      mm += m * m;
    }
    block_sum3<T, THREADS>(a, sw, mm, part, total);
    const T q = k2 - mm;
    T disc = sw * sw + a * q;
    disc = disc < T(0) ? T(0) : disc;  // clamp_min: a NaN stays NaN
    const T beta = (-sw + root(disc)) / a;

    // Done when no entry is negative (projfunc.m:40-44); else zero the
    // non-positive ones and redistribute (projfunc.m:49-53).  v takes
    // v_proj here; the zero mask of a vector found done is never read
    // again, so it is stored unconditionally too.
    T neg = 0, nz2 = 0, scl = 0;
    for (int i = t; i < N; i += THREADS) {
      const T m = z[i] ? T(0) : mid;
      const T vp = beta * (x[i] - m) + m;
      const bool zn = z[i] || vp <= T(0);
      neg += !(vp >= T(0));
      nz2 += zn;
      scl += zn ? T(0) : vp;
      x[i] = vp;
      z[i] = zn;
    }
    block_sum3<T, THREADS>(neg, nz2, scl, part, total);
    if (neg == T(0)) {
      done = true;
    } else {
      const T corr = (k1 - scl) / (n_all - nz2);
      for (int i = t; i < N; i += THREADS) x[i] = z[i] ? T(0) : x[i] + corr;
      nz = nz2;
    }
  }
  if (t == 0) {
    done_out[blockIdx.x] = done;
    iters_out[blockIdx.x] = p;
  }
}

template <typename T>
int launch(const T* S, T* v, unsigned char* zero, unsigned char* done, int* iters,
           long long B, int N, int passes, double k1, double k2, cudaStream_t stream) {
  if (B < 1 || B > 0x7fffffffLL || N < 1 || passes < 0) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)B;
  if (N >= LONG_N)
    hoyer_project_kernel<T, 1024><<<grid, 1024, 0, stream>>>(S, v, zero, done, iters, N,
                                                              passes, (T)k1, (T)k2);
  else
    hoyer_project_kernel<T, 256><<<grid, 256, 0, stream>>>(S, v, zero, done, iters, N,
                                                            passes, (T)k1, (T)k2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads per block for vectors of length N.
int nmf_hoyer_threads(int N) { return N >= LONG_N ? 1024 : 256; }

// Project the B contiguous rows of S (B x N) in at most `passes` passes:
// v (B x N) the projections, zero (B x N bytes) scratch, done (B bytes)
// and iters (B ints) each row's flag and pass count.  is_double selects
// double over float for S and v.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for B < 1, N < 1 or passes < 0).
int nmf_hoyer_project(const void* S, void* v, void* zero, void* done, void* iters,
                      long long B, int N, int passes, double k1, double k2,
                      int is_double, void* stream) {
  auto z = static_cast<unsigned char*>(zero);
  auto d = static_cast<unsigned char*>(done);
  auto it = static_cast<int*>(iters);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch(static_cast<const double*>(S), static_cast<double*>(v), z, d, it, B, N,
                  passes, k1, k2, st);
  return launch(static_cast<const float*>(S), static_cast<float*>(v), z, d, it, B, N, passes,
                k1, k2, st);
}

}  // extern "C"
