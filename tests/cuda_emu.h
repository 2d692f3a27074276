// Host emulation of the CUDA features the kernels of csrc/ use, so that
// they compile with a C++20 host compiler and run on the CPU
// (tests/test_torch_fused_emulated.py, tests/test_torch_hoyer_emulated.py,
// tests/test_torch_naive_kl_emulated.py).
// Each block (or each thread-block cluster) runs in turn; its threads are
// std::threads, __syncthreads is a block-wide barrier, and a warp's
// mma.sync gathers the 32 lanes' fragments through a warp barrier and
// gives each lane its part of the 16x8 product, as __shfl_xor_sync
// exchanges the lanes' values.  cp.async copies at once.  The test
// replaces the asm helpers of csrc/tile_ops.cuh with the ones below.
// A cluster's CTAs run together, cluster x threads std::threads: each
// CTA has its own block barrier, warps and dynamic shared memory
// (emu_cta_smem), and cooperative_groups::this_cluster() gives its rank,
// the cluster's size, map_shared_rank (the same offset in another rank's
// shared memory) and sync (one barrier over every thread of the cluster).
// The current card is emu_device (emu_set_device, exported for the tests);
// a cluster of more than 8 CTAs launches only where its kernel has the
// non-portable opt-in on the current card, as on an H100.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <set>
#include <thread>
#include <tuple>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 { unsigned x, y, z; };
inline thread_local emu_uint3 threadIdx, blockIdx;
inline emu_uint3 gridDim;
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline long long __double_as_longlong(double d) { long long u; std::memcpy(&u, &d, 8); return u; }
[[noreturn]] inline void __trap() { std::abort(); }
// Round-to-nearest f32 arithmetic: plain IEEE operations on the host,
// built with -ffp-contract=off so that none is fused into an FMA.
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
template <class T> T min(T a, T b) { return a < b ? a : b; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
       cudaErrorInvalidClusterSize = 912,
       cudaFuncAttributeMaxDynamicSharedMemorySize, cudaFuncAttributeNonPortableClusterSizeAllowed,
       cudaDevAttrMultiProcessorCount, cudaLaunchAttributeClusterDimension };
constexpr size_t kSmemLimit = 232448;  // an H100 block's opt-in maximum
inline const char* cudaGetErrorString(cudaError_t) { return "emulated error"; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline int emu_device = 0;
extern "C" void emu_set_device(int d) { emu_device = d; }
inline cudaError_t cudaGetDevice(int* d) { *d = emu_device; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return cudaSuccess; }
// (card, kernel) pairs with the non-portable cluster opt-in.
inline std::set<std::pair<int, const void*>> emu_nonportable;
inline std::mutex emu_nonportable_lock;
template <class K> bool emu_opted_in(K kernel) {
  std::lock_guard<std::mutex> hold(emu_nonportable_lock);
  return emu_nonportable.count({emu_device, reinterpret_cast<const void*>(kernel)}) > 0;
}
template <class K> cudaError_t cudaFuncSetAttribute(K kernel, int attr, int value) {
  if (attr == cudaFuncAttributeNonPortableClusterSizeAllowed) {
    std::lock_guard<std::mutex> hold(emu_nonportable_lock);
    if (value) emu_nonportable.insert({emu_device, reinterpret_cast<const void*>(kernel)});
    return cudaSuccess;
  }
  return value <= (int)kSmemLimit ? cudaSuccess : cudaErrorInvalidValue;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t smem) {
  *n = (int)min<size_t>(3, 233472 / (smem + 1024));
  return cudaSuccess;
}

inline thread_local std::barrier<>* emu_block_barrier;
inline thread_local unsigned char* emu_cta_smem;  // this CTA's dynamic shared memory
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
alignas(16) inline float4 emu_smem[kSmemLimit / 16];

inline void cp_async16(float* dst, const float* src, bool ok) {
  for (int i = 0; i < 4; ++i) dst[i] = ok ? src[i] : 0.f;
}
inline void cp_async4(float* dst, const float* src, bool ok) { dst[0] = ok ? src[0] : 0.f; }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

struct EmuWarp {
  std::barrier<>* bar;
  uint32_t a[32][4], b[32][2];
  double x[32];
};
inline thread_local EmuWarp* emu_warps;

// d += a b, m16n8k8: lane (g, t) = (lane / 4, lane % 4) holds
// a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g];
// d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  EmuWarp& w = emu_warps[threadIdx.x / 32];
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  w.bar->arrive_and_wait();
  auto A = [&](int r, int c) { return __uint_as_float(w.a[(r % 8) * 4 + c % 4][(r >= 8) + 2 * (c >= 4)]); };
  auto B = [&](int r, int c) { return __uint_as_float(w.b[c * 4 + r % 4][r >= 4]); };
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    double s = 0;
    for (int kk = 0; kk < 8; ++kk) s += (double)A(r, kk) * B(kk, c);
    d[e] = (float)(d[e] + s);
  }
  w.bar->arrive_and_wait();
}

// The value of lane (this lane ^ mask), all 32 lanes taking part.
inline double __shfl_xor_sync(unsigned, double v, int mask) {
  const int lane = threadIdx.x % 32;
  EmuWarp& w = emu_warps[threadIdx.x / 32];
  w.x[lane] = v;
  w.bar->arrive_and_wait();
  const double r = w.x[lane ^ mask];
  w.bar->arrive_and_wait();
  return r;
}

struct EmuCluster {
  std::barrier<>* bar;
  std::vector<unsigned char*> smem;  // each rank's dynamic shared memory
};
inline thread_local EmuCluster* emu_cluster;
inline thread_local unsigned emu_rank;

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu_rank; }
  unsigned num_blocks() const { return (unsigned)emu_cluster->smem.size(); }
  template <class T> T* map_shared_rank(T* p, unsigned rank) const {
    const auto off = reinterpret_cast<unsigned char*>(p) - emu_cta_smem;
    return reinterpret_cast<T*>(emu_cluster->smem[rank] + off);
  }
  void sync() const { emu_cluster->bar->arrive_and_wait(); }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// Run the `cluster` CTAs from block (x0, y, z) on together; a CTA's
// shared memory is `smem_of(rank)`, filled with 0xff bytes (unwritten
// shared memory reads as NaN).
template <class K, class M, class... Args>
void emu_run(K kernel, unsigned x0, unsigned y, unsigned z, int threads, unsigned cluster,
             size_t smem, M smem_of, Args&... args) {
  std::barrier<> all((std::ptrdiff_t)cluster * threads);
  EmuCluster info{&all, {}};
  std::vector<std::unique_ptr<std::barrier<>>> blocks;
  std::vector<std::vector<EmuWarp>> warps(cluster);
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  for (unsigned r = 0; r < cluster; ++r) {
    info.smem.push_back(smem_of(r));
    std::memset(info.smem.back(), 0xff, smem);
    blocks.push_back(std::make_unique<std::barrier<>>(threads));
    warps[r].resize((threads + 31) / 32);
    for (auto& w : warps[r]) w.bar = bars.emplace_back(std::make_unique<std::barrier<>>(32)).get();
  }
  std::vector<std::thread> ts;
  for (unsigned r = 0; r < cluster; ++r)
    for (int i = 0; i < threads; ++i)
      ts.emplace_back([&, r, i] {
        threadIdx = {(unsigned)i, 0, 0};
        blockIdx = {x0 + r, y, z};
        emu_block_barrier = blocks[r].get();
        emu_warps = warps[r].data();
        emu_cta_smem = info.smem[r];
        emu_cluster = &info;
        emu_rank = r;
        kernel(args...);
      });
  for (auto& t : ts) t.join();
}

template <class K, class... Args>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t, Args... args) {
  if (smem > sizeof(emu_smem)) std::abort();
  gridDim = {grid.x, grid.y, grid.z};
  auto shared = [](unsigned) { return reinterpret_cast<unsigned char*>(emu_smem); };
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x)
        emu_run(kernel, x, y, z, threads, 1, smem, shared, args...);
}

struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  int id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

inline unsigned emu_cluster_size(const cudaLaunchConfig_t* cfg) {
  for (unsigned a = 0; a < cfg->numAttrs; ++a)
    if (cfg->attrs[a].id == cudaLaunchAttributeClusterDimension)
      return cfg->attrs[a].val.clusterDim.x;
  return 1;
}

// An H100 places clusters of up to 16 CTAs, past 8 only with the opt-in
// on the current card (else the size is refused).
template <class K>
cudaError_t emu_cluster_allowed(K kernel, unsigned size) {
  return size <= 8 || (size <= 16 && emu_opted_in(kernel)) ? cudaSuccess
                                                            : cudaErrorInvalidClusterSize;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K kernel, const cudaLaunchConfig_t* cfg) {
  const unsigned size = emu_cluster_size(cfg);
  if (const cudaError_t e = emu_cluster_allowed(kernel, size)) return e;
  *n = (int)(132 / size);
  return cudaSuccess;
}

// A 1-D grid of 1-D clusters, one cluster at a time.
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...),
                               A&&... a) {
  const unsigned cluster = emu_cluster_size(cfg);
  const dim3 grid = cfg->gridDim;
  if (grid.y != 1 || grid.z != 1 || grid.x % cluster != 0) return cudaErrorInvalidConfiguration;
  if (const cudaError_t e = emu_cluster_allowed(kernel, cluster)) return e;
  gridDim = {grid.x, 1, 1};
  std::vector<std::vector<float4>> mem(cluster,
                                       std::vector<float4>(cfg->dynamicSmemBytes / 16 + 1));
  auto shared = [&](unsigned r) { return reinterpret_cast<unsigned char*>(mem[r].data()); };
  std::tuple<P...> args(a...);
  for (unsigned x = 0; x < grid.x; x += cluster)
    std::apply([&](auto&... xs) {
      emu_run(kernel, x, 0, 0, (int)cfg->blockDim.x, cluster, cfg->dynamicSmemBytes, shared,
              xs...);
    }, args);
  return cudaSuccess;
}
