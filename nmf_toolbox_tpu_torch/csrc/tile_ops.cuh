// Device helpers shared by fused.cu and fused_dma.cu (sm_90a): cp.async
// tile copies into shared memory, the 3xTF32 split and the TF32
// mma.sync.m16n8k8 tile product.  tests/cuda_emu.h emulates each asm
// helper here, so that the kernels also run on the CPU
// (tests/test_torch_fused_emulated.py).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// dst[r * dstr + c] = src[(r0 + r) * sstr + c0 + c] for r < rows, c < cols,
// zero where r0 + r >= rlim or c0 + c >= clim, by a block of NTH threads.
// vec: 16-byte copies (cols, c0, clim and sstr multiples of 4, src 16-byte
// aligned).
template <int NTH>
__device__ __forceinline__ void copy_tile(float* dst, int dstr, const float* src,
                                          size_t sstr, int r0, int c0, int rows,
                                          int cols, int rlim, int clim, bool vec) {
  // Copies of w floats, cq per row; thread e takes copies e, e + NTH, ...,
  // stepping (r, c) without a division per copy.
  const int w = vec ? 4 : 1, cq = cols / w, dr = NTH / cq, dc = NTH % cq;
  int r = threadIdx.x / cq, c = threadIdx.x % cq;
  while (r < rows) {
    const int gr = r0 + r, gc = c0 + c * w;
    const bool ok = gr < rlim && gc < clim;
    const float* s = ok ? src + (size_t)gr * sstr + gc : src;
    if (vec)
      cp_async16(dst + r * dstr + c * w, s, ok);
    else
      cp_async4(dst + r * dstr + c, s, ok);
    r += dr;
    c += dc;
    if (c >= cq) {
      c -= cq;
      ++r;
    }
  }
}

// tf32(x) rounded to nearest, ties away from zero, as cvt.rna.tf32.f32
// gives it for finite x, but in integer operations: conversions issue at
// an eighth of the rate of integer and f32 arithmetic on sm_90.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// hi = tf32(x), lo = tf32(x - hi); x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Split the n floats of buf (n a multiple of 4, buf 16-byte aligned) by a
// block of NTH threads: hi in place, lo to lo_out.
template <int NTH>
__device__ __forceinline__ void split_tile(float* buf, float* lo_out, int n) {
  for (int e = 4 * threadIdx.x; e < n; e += 4 * NTH) {
    const float4 x = *reinterpret_cast<const float4*>(&buf[e]);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *reinterpret_cast<float4*>(&buf[e]) = make_float4(
        __uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(&lo_out[e]) = make_float4(
        __uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// d += a b for a 16x8 (row) times 8x8 (col) TF32 tile, f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
