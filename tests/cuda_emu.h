// Host emulation of the CUDA features the kernels of csrc/ use, so that
// they compile with a C++20 host compiler and run on the CPU
// (tests/test_torch_fused_emulated.py).  Each block runs in turn; its
// threads are std::threads, __syncthreads is a block-wide barrier, and a
// warp's mma.sync gathers the 32 lanes' fragments through a warp barrier
// and gives each lane its part of the 16x8 product, as __shfl_xor_sync
// exchanges the lanes' values.  cp.async copies at once.  The test
// replaces the asm helpers of csrc/tile_ops.cuh with the ones below.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 { unsigned x, y, z; };
inline thread_local emu_uint3 threadIdx;
inline emu_uint3 blockIdx, gridDim;
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
template <class T> T min(T a, T b) { return a < b ? a : b; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize, cudaDevAttrMultiProcessorCount };
constexpr size_t kSmemLimit = 232448;  // an H100 block's opt-in maximum
inline const char* cudaGetErrorString(cudaError_t) { return "emulated error"; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return cudaSuccess; }
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int bytes) {
  return bytes <= (int)kSmemLimit ? cudaSuccess : cudaErrorInvalidValue;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t smem) {
  *n = (int)min<size_t>(3, 233472 / (smem + 1024));
  return cudaSuccess;
}

inline std::barrier<>* emu_block_barrier;
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
inline EmuWarp* emu_warps;

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

template <class K, class... Args>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t, Args... args) {
  if (smem > sizeof(emu_smem)) std::abort();
  gridDim = {grid.x, grid.y, grid.z};
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        std::memset(emu_smem, 0xff, smem);  // unwritten shared memory reads as NaN
        std::barrier<> block(threads);
        emu_block_barrier = &block;
        std::vector<EmuWarp> warps((threads + 31) / 32);
        std::vector<std::unique_ptr<std::barrier<>>> bars;
        for (auto& w : warps) w.bar = bars.emplace_back(std::make_unique<std::barrier<>>(32)).get();
        emu_warps = warps.data();
        std::vector<std::thread> ts;
        for (int i = 0; i < threads; ++i)
          ts.emplace_back([&, i] {
            threadIdx = {(unsigned)i, 0, 0};
            kernel(args...);
          });
        for (auto& t : ts) t.join();
      }
}
